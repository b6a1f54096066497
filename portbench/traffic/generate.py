"""The one generator every traffic mix goes through.

A mix is a data file beside this module (``<mix>.json``).  Its ``kind``
names the module that reads it (``<kind>.py`` here, found by name as the
metrics' readers are), and that module reads the mix's parameters and
nothing else: a key it does not name is refused (``check_keys``), so a
setting that nothing reads cannot pass for one that is run.  A new mix of
a known kind is a new data file; a new kind is a new module beside the
others, and no file that is there changes.

Kinds (each module's docstring has its parameters):

- ``open_loop``: independent requests at fixed due times, Poisson or
  on/off arrivals, optional shared documents;
- ``sessions``: multi-turn sessions over one shared system prompt, a
  turn sent a think time after the reply to the turn before;
- ``batches``: training batches made on the card.

What every request kind shares: the sizes (prompt and output lengths,
gaps, popularity draws) are one fixed sequence drawn from the mix's
``sizes_seed``, and ``--seed`` draws only the token ids, so every seed
offers the same work at the same times (a permutation by seed moved the
TTFT tail by half its median between seeds where two runs of one seed
agreed within 4%; PERF.md, §6).  ``temperature`` (0 is greedy) with
``greedy_share`` below 1 mixes sampled requests in; only greedy ones are
checked.
"""

from __future__ import annotations

import dataclasses
import importlib
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent

# Keys every mix may carry besides its kind's.
COMMON_KEYS = frozenset({"kind", "note"})


@dataclasses.dataclass
class Planned:
    """One request of a schedule."""
    index: int
    due_s: float                 # offset from the schedule's start
    prompt: List[int]            # after ``after``'s history, if any
    max_tokens: int
    document: Optional[int] = None
    # A later turn: sent ``think_s`` after request ``after`` finished, its
    # prompt that request's prompt and reply followed by ``prompt``.
    after: Optional[int] = None
    think_s: float = 0.0
    bound: int = 0               # the longest the sent prompt can be
    temperature: float = 0.0

    def __post_init__(self):
        self.bound = max(self.bound, len(self.prompt))


def kind(mix: Dict) -> ModuleType:
    name = mix["kind"]
    if not (HERE / f"{name}.py").exists() or name == "generate":
        raise ValueError(f"no traffic kind {name!r} "
                         f"(traffic/{name}.py is missing)")
    return importlib.import_module(f"portbench.traffic.{name}")


def check_keys(mix: Dict) -> None:
    extra = set(mix) - COMMON_KEYS - set(kind(mix).KEYS)
    if extra:
        raise ValueError(f"mix keys {sorted(extra)} are read by nothing "
                         f"(kind {mix['kind']!r})")


def schedule(mix: Dict, vocab: int, seed: int, horizon_s: float,
             rate_per_s: Optional[float] = None) -> List[Planned]:
    """The requests of a mix whose first turn is due in [0, horizon_s)."""
    return kind(mix).schedule(mix, vocab, seed, horizon_s, rate_per_s)


def shared_prefixes(mix: Dict, vocab: int, seed: int) -> List[List[int]]:
    """Token lists a deployment holds before the traffic comes (documents,
    a system prompt): set-up prefills each once, so the pool holds them."""
    fn = getattr(kind(mix), "shared_prefixes", None)
    return fn(mix, vocab, seed) if fn else []


def batches(mix: Dict, vocab: int, seed: int, device, count: int = 0):
    return kind(mix).batches(mix, vocab, seed, device, count)


def lengths(rng: np.random.Generator, spec: Dict, n: int) -> np.ndarray:
    if spec["dist"] == "lognormal":
        x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    elif spec["dist"] == "uniform":
        x = rng.uniform(spec["min"], spec["max"] + 1, n)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.floor(x), spec["min"], spec["max"]).astype(np.int64)


def zipf_ranks(rng: np.random.Generator, count: int, s: float,
               n: int) -> np.ndarray:
    """n draws of ranks 0..count-1 with P(k) proportional to 1/(k+1)^s."""
    p = 1.0 / np.arange(1, count + 1) ** s
    return rng.choice(count, size=n, p=p / p.sum())


def token_rng(seed: int, stream: int) -> np.random.Generator:
    # Any whole number is a valid seed (numpy folds big ints); the stream
    # keeps the prompts' and the shared prefixes' ids independent.
    return np.random.default_rng([abs(int(seed)), int(seed < 0), stream])


def token_ids(rng: np.random.Generator, vocab: int, n: int,
              spec: Optional[Dict] = None) -> List[int]:
    """``n`` ids: uniform over the vocabulary, or with ``{"dist":
    "repeat", "min": a, "max": b}`` one uniform pattern of a to b ids
    repeated (text that prompt-lookup drafting can follow)."""
    dist = (spec or {"dist": "uniform"})["dist"]
    if dist == "uniform":
        return rng.integers(0, vocab, n).tolist()
    if dist == "repeat":
        period = int(rng.integers(spec["min"], spec["max"] + 1))
        pattern = rng.integers(0, vocab, period).tolist()
        return (pattern * (n // period + 1))[:n]
    raise ValueError(f"unknown id distribution {dist!r}")


def temperatures(mix: Dict, n: int) -> np.ndarray:
    """Each request's temperature: ``temperature``, but 0 (greedy) for a
    ``greedy_share`` of them drawn from the sizes' own stream."""
    temp = float(mix.get("temperature", 0.0))
    share = float(mix.get("greedy_share", 1.0))
    if temp == 0.0 or share >= 1.0:
        return np.zeros(n)
    greedy = np.random.default_rng(mix["sizes_seed"] + 2).random(n) < share
    return np.where(greedy, 0.0, temp)


def prefill_buckets(plans: List[Planned], max_len: int) -> List[int]:
    """Every power-of-two prefill bucket (32 up) a schedule can need,
    with or without a prefix served from the cache."""
    longest = max(p.bound for p in plans)
    out, b = [], 32
    while True:
        out.append(min(b, max_len))
        if b >= min(longest, max_len):
            return out
        b *= 2
