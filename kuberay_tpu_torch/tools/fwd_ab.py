"""A/B of the attention forward between this tree and another, on one card.

    python3 -m kuberay_tpu_torch.tools.fwd_ab --parent DIR [--train]
        [--profile] [--out chiprun_out/fwd_ab.json]

DIR is a checkout of another commit (e.g. ``git archive <commit>``
unpacked into the git-ignored ``_scratch/``).  In turns (the other tree,
this one, this one, the other), a child process in that tree (its
directory the working directory and ``PYTHONPATH``) builds the tree's
kernels and:

- runs ``flash_fwd`` on every shape of this tree's
  ``chip_smoke.FLASH_SHAPES``, on inputs drawn from one seeded generator,
  and keeps a SHA-256 of out's and lse's bytes;
- times ``flash_fwd`` and SDPA at llama_1b's shape (B 4, S 2048, 16/8
  heads of 128, causal) from a CUDA graph, and the whole ring's forward
  (``ring_attention(impl="rdma")`` over ``LocalRing(4)`` at B 2 x S 4096,
  the shards' copies included) eagerly and from a CUDA graph;
- with ``--train``, runs the tree's ``chip_smoke.train()`` and
  ``chip_smoke.train_ring()`` (with ``--profile``, one profiled
  long-context step) and keeps their step times.

Then it holds the hashes of the four turns to each other (the forward's
bits across trees and repeats) and writes one JSON record.  Times are CUDA
events (ms); quote them with the card's name and power limit, which the
record carries.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
TREE = HERE.parents[2]


def _digest(t) -> str:
    """SHA-256 (16 hex digits) of a tensor's bytes."""
    import torch
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def child(shapes, train: bool, profile: bool) -> dict:
    """The measurements in the tree this process imports from."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from kuberay_tpu_torch.ops import _build
    from kuberay_tpu_torch.ops import attention as fa
    from kuberay_tpu_torch.parallel.mesh import LocalRing
    from kuberay_tpu_torch.parallel.ring import ring_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    rec = {"build_s": time.perf_counter() - t0, "bits": {}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, B, Sq, Skv, Hq, Hkv, D, causal in shapes:
        q = torch.randn(B, Sq, Hq, D, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(B, Skv, Hkv, D, generator=gen, device="cuda"
                            ).bfloat16() for _ in range(2))
        out, lse = fa.flash_fwd(q, k, v, causal)
        rec["bits"][name] = [_digest(out), _digest(lse)]
    q = torch.randn(4, 2048, 16, 128, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(4, 2048, 8, 128, generator=gen, device="cuda"
                        ).bfloat16() for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    rec["flash_fwd_graph_ms"] = cs.graph_ms(lambda: fa.flash_fwd(q, k, v), 20)
    rec["sdpa_graph_ms"] = cs.graph_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True), 20)
    q = torch.randn(2, 4096, 16, 128, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(2, 4096, 8, 128, generator=gen, device="cuda"
                        ).bfloat16() for _ in range(2))
    ring = LocalRing(4, "cuda")
    with torch.no_grad():
        fwd = lambda: ring_attention(q, k, v, ring, impl="rdma")  # noqa
        rec["ring_fwd_ms"] = cs.cuda_ms(fwd, 20)
        rec["ring_fwd_graph_ms"] = cs.graph_ms(fwd, 20)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    if train:
        trn = cs.train()
        rec["launcher_step_ms"] = trn["launcher"]["step_ms"]
        rec["fixed_step_ms"] = trn["fixed_batch"]["step_ms"]
        rng = cs.train_ring(profile=profile)
        rec["long_context_step_ms"] = rng["step_ms"]
        if profile:
            rec["long_context_profile"] = {
                k: rng["profile"][k] for k in ("wall_ms", "device_busy_ms",
                                               "idle_share")}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other tree")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=str(TREE / "chiprun_out" / "fwd_ab.json"))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        task = json.loads(args.child)
        res = child(task["shapes"], task["train"], task["profile"])
        print("FWD_AB " + json.dumps(res), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("fwd_ab: no CUDA device")
    if not args.parent:
        raise SystemExit("fwd_ab: --parent DIR is required")
    sys.path.insert(0, str(TREE))
    import chip_smoke as cs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    task = json.dumps({"shapes": cs.FLASH_SHAPES, "train": args.train,
                       "profile": args.profile})
    trees = {"parent": Path(args.parent).resolve(), "this": TREE}
    turns = []
    for tag in ("parent", "this", "this", "parent"):
        tree = trees[tag]
        env = {**os.environ, "PYTHONPATH": str(tree)}
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, str(HERE), "--child", task],
                           cwd=tree, env=env, capture_output=True, text=True,
                           timeout=900)
        line = [ln for ln in p.stdout.splitlines()
                if ln.startswith("FWD_AB ")]
        if p.returncode != 0 or not line:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"fwd_ab: the {tag} turn failed "
                             f"(exit {p.returncode})")
        rec = json.loads(line[-1][len("FWD_AB "):])
        rec.update(tree=tag, wall_s=time.perf_counter() - t0)
        turns.append(rec)
        print(f"{tag}: " + json.dumps({k: v for k, v in rec.items()
                                       if k != "bits"}), flush=True)
    bits = [t["bits"] for t in turns]
    same = {name: all(b[name] == bits[0][name] for b in bits)
            for name in bits[0]}
    out = {"device": smi, "turns": turns, "bits_equal": same}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"device": smi, "bits_equal": same}), flush=True)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
