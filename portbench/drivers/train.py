"""Training cells: the launcher's step, ``make_train_step``, on one card.

Set-up builds the one train state (master weights from the seed, Adam's
zeroed moments) and the one step, makes the mix's batches on the card,
and drives the step through its first ``check.steps`` steps on rows that
all differ: those steps warm every shape and kernel (the nvcc build, the
Triton JIT), and their loss, the first gradient (from Adam's first moment
after one step) and the parameters' change after the last are kept for
the check.  The window then drives the same state through the same call
for ``--seconds``: the host runs at most two steps ahead (a CUDA event a
step), and the window's ends are device syncs; the rate counts every
token of every step finished inside it.

With ``--trace 1``, ``torch.profiler`` captures ``profile_steps`` steps
in the middle of the window, between two syncs.

After the window the memory peak is read, the state freed, and the
configuration's family's reference follows the check steps from the same
weights and rows (``families/<family>.py::reference_train``).  The step's
settings (remat, dtypes, the optimizer's) are the configuration's
``train`` group.
"""

from __future__ import annotations

import collections
import gc
import time
from typing import Dict

import torch

from portbench import check, harness, profiling
from portbench.traffic import generate

CELL_KEYS = ("profile_steps", "check")
CHECK_KEYS = {"steps", "limits"}


def _norms(fam, tree, names, fn=lambda name, t: t) -> Dict[str, float]:
    return {n: float(fn(n, fam.get_leaf(tree, n)).float().norm())
            for n in names}


def run(ctx) -> Dict:
    from kuberay_tpu_torch.train.train_step import (
        TrainConfig,
        make_optimizer,
        make_train_step,
    )

    cell, config, mix = ctx.cell, ctx.config, ctx.mix
    extra = set(cell["check"]) - CHECK_KEYS
    if extra:
        raise ValueError(f"check keys {sorted(extra)} are read by nothing")
    tr = config["train"]
    fam = harness.family(config)
    dims = fam.dims(config)
    cuda = ctx.device == "cuda"
    dev = ctx.device
    master = fam.DTYPES[tr["param_dtype"]]
    tc = TrainConfig(learning_rate=tr["learning_rate"],
                     warmup_steps=tr["warmup_steps"],
                     decay_steps=tr["decay_steps"],
                     weight_decay=tr["weight_decay"], beta1=tr["beta1"],
                     beta2=tr["beta2"], grad_clip=tr["grad_clip"],
                     z_loss=tr["z_loss"], param_dtype=tr["param_dtype"],
                     mu_dtype=tr["mu_dtype"])
    opt = make_optimizer(tc)
    step = make_train_step(fam.port_config(config, train=tr), tc, opt)
    for hook in ctx.options.get("step_hooks", ()):
        step = hook(step)
    names = fam.leaf_names(config)

    phases = {"imports": time.perf_counter() - ctx.t_start}
    t = time.perf_counter()
    params = fam.make_params(config, ctx.seed, dev, master)
    state = {"step": 0, "params": params, "opt_state": opt.init(params)}
    del params
    data = generate.batches(mix, dims.vocab, ctx.seed, dev)
    feed = [{"tokens": b[:, :-1].contiguous(),
             "targets": b[:, 1:].contiguous()} for b in data]
    n_check = int(cell["check"]["steps"])
    if n_check > len(feed):
        raise ValueError("the mix's pool is smaller than the check steps")

    phases["state"] = time.perf_counter() - t
    t = time.perf_counter()
    losses = []
    grad1 = None
    for k in range(n_check):
        state, m = step(state, feed[k])
        losses.append(float(m["total_loss"]))
        if k == 0:
            grad1 = _norms(fam, state["opt_state"]["mu"], names,
                           lambda n, t: t / (1.0 - tc.beta1))
    change = _norms(fam, state["params"], names, lambda n, t: t - (
        fam.make_leaf(config, ctx.seed, n, dev, master)))
    program = {"losses": losses, "grad1": grad1, "change": change}
    phases["check_steps"] = time.perf_counter() - t

    if cuda:
        torch.cuda.synchronize()
    w0 = time.perf_counter()
    setup_s = w0 - ctx.t_start
    done, i = 0, n_check
    pending: collections.deque = collections.deque()
    cap = None
    prof_steps = int(cell.get("profile_steps", 2))
    while time.perf_counter() - w0 < ctx.seconds:
        if ctx.trace and cap is None and \
                time.perf_counter() - w0 >= ctx.seconds / 2:
            if cuda:
                torch.cuda.synchronize()
            cap = profiling.Capture(cuda)
            cap.start()
            for _ in range(prof_steps):
                state, m = step(state, feed[i % len(feed)])
                i += 1
                done += 1
            cap.stop()
            continue
        state, m = step(state, feed[i % len(feed)])
        i += 1
        done += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > 2:
                pending.popleft().synchronize()
    if cuda:
        torch.cuda.synchronize()
    w1 = time.perf_counter()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    tokens_per_step = mix["batch"] * mix["seq_len"]
    ref_batches = [data[k].clone() for k in range(n_check)]
    del state, m, feed, data
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    record: Dict = {
        "kind": "train", "setup_s": setup_s, "window": [w0, w1],
        "dims": dims, "batch": mix["batch"], "seq_len": mix["seq_len"],
        "device_name": (torch.cuda.get_device_name(0) if cuda else "cpu"),
        "memory_peak_bytes": memory_peak, "steps": done,
        "tokens": done * tokens_per_step, "attempted": done, "failed": 0,
        "phases": phases}
    if cap is not None:
        record["profile"] = profiling.summarize(
            cap.events(), cap.t1 - cap.t0, cap.thread)
        record["profile_steps"] = prof_steps

    t = time.perf_counter()
    p0 = fam.make_params(config, ctx.seed, dev, torch.float32)
    reference = fam.reference_train(p0, config, ref_batches)
    del p0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    phases["reference"] = time.perf_counter() - t
    numbers = check.train_numbers(program, reference)
    ok, checked = check.verdict(numbers, cell["check"]["limits"])
    record.update(correct=ok, checked=checked, numbers=numbers,
                  program=program, reference=reference)
    return record
