"""Multi-turn sessions over one shared system prompt.

Sessions start with Poisson arrivals; each has a number of turns.  The
first turn's prompt is the system prompt followed by the user's tokens;
each later turn is sent ``think_s`` after the reply to the turn before has
finished, its prompt that turn's prompt and reply followed by the user's
new tokens (the serving driver builds it: ``Planned.after``).  So the
prefix cache, or the KV tiers behind it, serve every turn's history.

Parameters of a mix of this kind:

- ``rate_per_s``: sessions started a second;
- ``sizes_seed``, ``pool``: the fixed draws of sizes and gaps (``pool``
  sessions);
- ``system``: the system prompt's length distribution, one draw;
- ``turns``: ``{"min", "max"}`` turns a session, uniform;
- ``think_s``: the mean of the exponential wait before a later turn;
- ``prompt``, ``output``: a turn's user tokens and reply, as in
  ``open_loop``;
- ``ids``, ``temperature``, ``greedy_share`` (optional): as in
  ``open_loop``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from portbench.traffic.generate import (
    Planned,
    lengths,
    temperatures,
    token_ids,
    token_rng,
)

KEYS = ("rate_per_s", "sizes_seed", "pool", "system", "turns", "think_s",
        "prompt", "output", "ids", "temperature", "greedy_share")


def shared_prefixes(mix: Dict, vocab: int, seed: int) -> List[List[int]]:
    """The system prompt."""
    n = int(lengths(np.random.default_rng(mix["sizes_seed"] + 1),
                    mix["system"], 1)[0])
    return [token_rng(seed, 4).integers(0, vocab, n).tolist()]


def schedule(mix: Dict, vocab: int, seed: int, horizon_s: float,
             rate_per_s: Optional[float] = None) -> List[Planned]:
    rate = float(rate_per_s if rate_per_s is not None else mix["rate_per_s"])
    n = int(mix["pool"])
    sizes = np.random.default_rng(mix["sizes_seed"])
    turns = sizes.integers(mix["turns"]["min"], mix["turns"]["max"] + 1, n)
    gaps = sizes.exponential(1.0, n)
    total = int(turns.sum())
    prompt_lens = lengths(sizes, mix["prompt"], total)
    out_lens = lengths(sizes, mix["output"], total)
    thinks = sizes.exponential(float(mix["think_s"]), total)
    temps = temperatures(mix, total)
    system = shared_prefixes(mix, vocab, seed)[0]
    tok = token_rng(seed, 5)
    out: List[Planned] = []
    t, k = 0.0, 0
    for s in range(n):
        t += gaps[s] / rate
        if t >= horizon_s:
            return out
        prev, bound = None, len(system)
        for j in range(int(turns[s])):
            user = token_ids(tok, vocab, int(prompt_lens[k]), mix.get("ids"))
            bound += len(user)
            out.append(Planned(
                len(out), t, system + user if prev is None else user,
                int(out_lens[k]), after=prev,
                think_s=0.0 if prev is None else float(thinks[k]),
                bound=bound, temperature=float(temps[k])))
            bound += int(out_lens[k])
            prev, k = len(out) - 1, k + 1
    raise ValueError(f"pool {n} runs out before {horizon_s} s at "
                     f"{rate} sessions/s; raise the mix's pool")
