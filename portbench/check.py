"""The comparisons that decide ``correct``, against the plain reference.

Serving: a sample of the finished requests, drawn from the seed and
holding the longest; the reference runs once over each prompt with its
served tokens, and ``served_logit_gap`` is the widest gap by which a served
(greedy) token's logit lies below the reference's best at its position;
``served_gap_mean`` the mean of those gaps and ``served_mismatch_share``
the share of served tokens that are not the reference's best.

Training: the program's first steps, which set-up drove through the
window's own call, against the reference following the same steps from
the same weights and rows.  ``loss_gap``: the largest relative gap of a
step's loss.  ``grad_gap``: over leaves, the gap between the norms of the
program's and the reference's first gradient as the optimizer gets it
(after clipping; the program's worked out from Adam's first moment after
one step), over the larger of the reference's norm of that leaf and of the
median leaf.  ``change_gap``: the same of the parameters' change after the
last step, over the leaves whose reference gradient is at least a
thousandth of the median leaf's (a leaf below that moves by round-off
alone).

A number passes when it is at most its limit (``limits`` in the cell
file); a number that is not finite fails.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

LEAF_RULE = 1e-3


def sample_requests(finished: Sequence[Tuple[List[int], List[int]]],
                    seed: int, min_served: int, max_requests: int
                    ) -> List[int]:
    """Indices into ``finished`` ((prompt, served) pairs): the longest,
    then others in an order drawn from the seed until ``min_served``
    served tokens or ``max_requests`` requests."""
    if not finished:
        return []
    sizes = [len(p) + len(s) for p, s in finished]
    longest = int(np.argmax(sizes))
    pick = [longest]
    served = len(finished[longest][1])
    order = np.random.default_rng([abs(int(seed)), 11]).permutation(
        len(finished))
    for i in order:
        if served >= min_served or len(pick) >= max_requests:
            break
        if i != longest:
            pick.append(int(i))
            served += len(finished[i][1])
    return pick


def served_gaps(ref_logits, served: Sequence[int]) -> List[float]:
    """Per served token: the reference's best logit minus its own."""
    import torch

    idx = torch.as_tensor(list(served), device=ref_logits.device)
    best = ref_logits.max(-1).values
    own = ref_logits.gather(-1, idx[:, None])[:, 0]
    return (best - own).tolist()


def serve_numbers(family, params, config: Dict,
                  samples: Sequence[Tuple[List[int], List[int]]],
                  lowp=None) -> Dict[str, float]:
    """``served_logit_gap`` over the samples, the reference being the
    configuration's ``family``'s.  With ``lowp`` (a control precision of
    the reference) the tokens judged are the ones that precision puts
    first at each served position, not the served ones."""
    all_gaps: List[float] = []
    for prompt, served in samples:
        if not served:
            continue
        seq = list(prompt) + list(served[:-1])
        rows = range(len(prompt) - 1, len(seq))
        logits = family.reference_logits(params, config, seq, rows)
        toks = served
        if lowp is not None:
            toks = family.reference_logits(params, config, seq, rows,
                                           lowp).argmax(-1).tolist()
        all_gaps += served_gaps(logits, toks)
        del logits
    n = max(1, len(all_gaps))
    return {"served_logit_gap": max(all_gaps, default=0.0),
            "served_gap_mean": sum(all_gaps) / n,
            "served_mismatch_share": sum(g > 0 for g in all_gaps) / n,
            "served_tokens_compared": len(all_gaps)}


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[Sequence[str]] = None) -> float:
    names = list(keep if keep is not None else ref)
    floor = statistics.median(ref[n] for n in ref)
    return max(abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30)
               for n in names)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    g_med = statistics.median(ref["grad1"].values())
    moved = [n for n, g in ref["grad1"].items() if g >= LEAF_RULE * g_med]
    return {"loss_gap": loss_gap,
            "grad_gap": _leaf_gap(prog["grad1"], ref["grad1"]),
            "change_gap": _leaf_gap(prog["change"], ref["change"], moved)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {"value", "limit"}}) over the limited numbers."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, float("nan"))
        out[name] = {"value": v, "limit": limit}
        if not (isinstance(v, (int, float)) and math.isfinite(v)
                and v <= limit):
            ok = False
    return ok, out
