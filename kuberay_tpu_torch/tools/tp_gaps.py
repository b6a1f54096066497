"""How close a tp=2 paged group's greedy tokens come to the recompute
margin, over prompt sets and arrival orders, beside a one-process paged
engine's, on one card.

    python3 -m kuberay_tpu_torch.tools.tp_gaps [--seeds 10 11 12 13]
        [--out chiprun_out/tp_gaps.json]

``chip_smoke.serve_tp_tiers`` serves one first wave (seed 10's prompts,
the first alone, then the other seven together) and fails if a served
token's logit in the no-cache bf16 recompute of the whole tree sits more
than 5% of the largest |logit| below the best (``check_against_recompute``).
This reads whether that wave's prompts or order are the ones that happen
to pass.  It starts llama3_8b's server as a tp=2 group sharing the card
over gloo (``chip_smoke.ServeGroup``, ``--paged`` with serve_tp_tiers'
pool and no host tier, so a wave whose blocks were evicted prefills
anew) and a one-process ``PagedServeEngine`` with the same pool behind
its frontend.  For each order (``pinned``: the smoke's; ``together``:
all eight at once, the engine admitting them as they arrive) and each
seed it draws ``chip_smoke.tpt_first_wave`` from that seed, serves it to
both, and keeps each prompt's worst gap over its margin (above 1 fails
the smoke) and the tokens each side prefilled (a whole wave's, when its
blocks were gone).  Writes one JSON record with the card's name and
power limit; exits non-zero only if the run did not complete.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]


def gap_over_margin(cs, cfg, params, prompt, tokens) -> float:
    """The served tokens' worst recompute gap over the smoke's margin
    (the check itself run with a margin no gap reaches, so nothing
    raises)."""
    wide = 2.0                    # max - served <= 2 max|logit|, always
    c = cs.check_against_recompute(cfg, params, prompt, tokens,
                                   margin_frac=wide)
    return c["max_gap"] / (c["margin"] / wide
                           * cs.RECOMPUTE_MARGIN["bf16"])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[10, 11, 12, 13])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "tp_gaps.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tp_gaps: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from kuberay_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _build.build_all()
    cfg = cs.llama.CONFIGS["llama3_8b"]
    params = cs.llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    pool = ("--paged", "--block-size", str(cs.BLOCK_SIZE), "--num-blocks",
            str(cs.TPT_BLOCKS))
    replica = cs.PagedServeEngine(cfg, params, max_slots=cs.SLOTS,
                                  max_len=cs.MAX_LEN,
                                  block_size=cs.BLOCK_SIZE,
                                  num_blocks=cs.TPT_BLOCKS, device="cuda")
    fe = cs.ServeFrontend(replica)
    rsrv, rurl = fe.serve_background("127.0.0.1", 0)
    g = cs.ServeGroup(2, "gloo", *pool)
    waves = []
    try:
        g.ready()
        sides = (("group", g.url, lambda: g.get("/stats")[1]),
                 ("replica", rurl, fe.stats))
        for order in ("pinned", "together"):
            for seed in args.seeds:
                prompts = cs.tpt_first_wave(cfg, np.random.default_rng(seed))
                row = {"order": order, "seed": seed}
                for side, url, stats in sides:
                    before = cs.prefilled(stats())
                    tokens = cs.serve_first_wave(url, prompts,
                                                 order == "pinned")
                    row[side] = {
                        "prefilled": cs.prefilled(stats()) - before,
                        "gap_over_margin": [
                            gap_over_margin(cs, cfg, params, p, t)
                            for p, t in zip(prompts, tokens)]}
                waves.append(row)
                print("wave " + json.dumps(row), flush=True)
        rcs = g.stop()
    finally:
        g.kill()
        rsrv.shutdown()
        rsrv.server_close()
        fe.close()
    if rcs != [0, 0]:
        raise SystemExit(f"tp_gaps: the group exited {rcs}: {g.tail()}")
    worst = {side: max(max(w[side]["gap_over_margin"]) for w in waves)
             for side in ("group", "replica")}
    rec = {"card": smi, "pool": list(pool), "seeds": args.seeds,
           "waves": waves, "worst": worst}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rec, indent=1))
    print(f"tp_gaps [{smi}]: worst gap over margin {json.dumps(worst)}",
          flush=True)


if __name__ == "__main__":
    main()
