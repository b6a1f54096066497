"""Independent requests at fixed due times (an open loop).

Parameters of a mix of this kind:

- ``rate_per_s``: requests a second (during ``on`` with on/off arrivals);
- ``sizes_seed``, ``pool``: the fixed sequence of ``pool`` draws of sizes
  and gaps (``generate``'s docstring);
- ``prompt``, ``output``: length distributions (``lognormal`` with
  ``median`` and ``sigma``, or ``uniform``; both clipped to ``min`` to
  ``max``);
- ``arrivals`` (optional): ``{"process": "poisson"}``, the default, or
  ``{"process": "on_off", "on_s": a, "off_s": b, "off_share": f}``:
  alternating phases, ``rate_per_s`` during the ``a`` seconds on and
  ``f`` times it during the ``b`` seconds off;
- ``documents`` (optional): ``{"count", "min", "max", "zipf_s"}``: each
  prompt is one of ``count`` shared documents of ``min`` to ``max`` tokens,
  chosen by Zipf popularity, followed by a question of ``prompt`` length;
- ``ids`` (optional): ``generate.token_ids``'s spec;
- ``temperature``, ``greedy_share`` (optional): ``generate.temperatures``.
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
    zipf_ranks,
)

KEYS = ("rate_per_s", "sizes_seed", "pool", "prompt", "output", "arrivals",
        "documents", "ids", "temperature", "greedy_share")


def shared_prefixes(mix: Dict, vocab: int, seed: int) -> List[List[int]]:
    """The mix's documents (else [])."""
    spec = mix.get("documents")
    if not spec:
        return []
    sizes = np.random.default_rng(mix["sizes_seed"] + 1)
    lens = sizes.integers(spec["min"], spec["max"] + 1, spec["count"])
    tok = token_rng(seed, 4)
    return [tok.integers(0, vocab, int(n)).tolist() for n in lens]


def on_off_times(gaps: np.ndarray, rate: float, on_s: float, off_s: float,
                 off_share: float) -> List[float]:
    """Arrival times of unit-rate ``gaps`` under a rate of ``rate`` for
    ``on_s`` seconds, then ``rate * off_share`` for ``off_s``, repeated."""
    out: List[float] = []
    t, on, end = 0.0, True, on_s
    for g in gaps:
        while True:
            r = rate if on else rate * off_share
            if r > 0 and t + g / r < end:
                t += g / r
                break
            g -= (end - t) * r
            t, on = end, not on
            end = t + (on_s if on else off_s)
        out.append(t)
    return out


def schedule(mix: Dict, vocab: int, seed: int, horizon_s: float,
             rate_per_s: Optional[float] = None) -> List[Planned]:
    rate = float(rate_per_s if rate_per_s is not None else mix["rate_per_s"])
    n = int(mix["pool"])
    sizes = np.random.default_rng(mix["sizes_seed"])
    prompt_lens = lengths(sizes, mix["prompt"], n)
    out_lens = lengths(sizes, mix["output"], n)
    gaps = sizes.exponential(1.0, n)               # in units of 1 / rate
    doc_spec = mix.get("documents")
    ranks = (zipf_ranks(sizes, doc_spec["count"], doc_spec["zipf_s"], n)
             if doc_spec else None)
    arrivals = mix.get("arrivals") or {"process": "poisson"}
    if arrivals["process"] == "poisson":
        times, t = [], 0.0
        for g in gaps:
            t += g / rate
            times.append(t)
    elif arrivals["process"] == "on_off":
        times = on_off_times(gaps, rate, float(arrivals["on_s"]),
                             float(arrivals["off_s"]),
                             float(arrivals.get("off_share", 0.0)))
    else:
        raise ValueError(f"unknown arrival process {arrivals['process']!r}")
    temps = temperatures(mix, n)
    docs = shared_prefixes(mix, vocab, seed)
    tok = token_rng(seed, 5)
    out: List[Planned] = []
    for i in range(n):
        if times[i] >= horizon_s:
            return out
        question = token_ids(tok, vocab, int(prompt_lens[i]), mix.get("ids"))
        doc = None
        if ranks is not None:
            doc = int(ranks[i])
            question = docs[doc] + question
        out.append(Planned(i, times[i], question, int(out_lens[i]), doc,
                           temperature=float(temps[i])))
    raise ValueError(f"pool {n} runs out before {horizon_s} s at "
                     f"{rate} requests/s; raise the mix's pool")
