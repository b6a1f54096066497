"""PyTorch port, the training path vs the JAX package on ``llama_tiny``.

- ``loss_fn``: loss, metrics and every leaf's gradient against
  ``jax.value_and_grad(llama.loss_fn)``, with a mask, dense and chunked
  cross entropy, every remat policy, and both of the port's attention
  paths (the plain ``attention_ref`` and the flash autograd rule).
- ``make_train_step``: 5 steps against the JAX step (losses, gradient
  norms, then every parameter and Adam moment through ``state_from_jax``),
  with the default clip triggering, with interleaved gradient accumulation
  over a ragged mask, and with chunked cross entropy and no clip; the
  optimizer's schedule against optax; one mixed-precision step (bf16
  compute, f32 masters).

Tolerances: float32 1e-5 absolute for losses, metrics and gradients
(summation order), parameters and moments 1e-5 relative to each leaf's
largest value; the bf16 step's in the test, with their reasons.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kuberay_tpu.models import llama as jllama
from kuberay_tpu.train import train_step as jts
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.models.convert import params_from_jax, state_from_jax
from kuberay_tpu_torch.train import train_step as tts

torch.set_num_threads(2)

B, S = 4, 16


def _cfgs(**kw):
    """The JAX and the port's llama_tiny with the same overrides; the
    port's attention path is picked with ``attn``."""
    attn = kw.pop("attn", "xla")
    jdtype = kw.pop("jdtype", None)
    tdtype = kw.pop("tdtype", None)
    jcfg = dataclasses.replace(jllama.CONFIGS["llama_tiny"], **kw)
    tcfg = dataclasses.replace(tllama.CONFIGS["llama_tiny"], attn_impl=attn,
                               **kw)
    if jdtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=jdtype)
        tcfg = dataclasses.replace(tcfg, dtype=tdtype)
    return jcfg, tcfg


def _batch(seed, vocab, masked=False, n=B):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, vocab, (n, S)).astype(np.int32),
         "targets": rng.integers(0, vocab, (n, S)).astype(np.int32)}
    if masked:
        m = (rng.uniform(size=(n, S)) > 0.3).astype(np.float32)
        m[1, :] = 0.0                 # one row with no real token
        b["mask"] = m
    return b


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("xent_chunk", [0, 96])
@pytest.mark.parametrize("attn", ["xla", "auto"])
def test_loss_fn_grads_match_jax(xent_chunk, attn):
    """Every remat policy gives the same numbers, and they match JAX."""
    jcfg, tcfg = _cfgs(xent_chunk=xent_chunk, attn=attn)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    b = _batch(1, jcfg.vocab_size, masked=True)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jllama.loss_fn(jcfg, p, jnp.asarray(b["tokens"]),
                                 jnp.asarray(b["targets"]),
                                 jnp.asarray(b["mask"])), has_aux=True)(jparams)
    jflat = _flat(_np_tree(jgrads))
    results = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        cfg = dataclasses.replace(tcfg, remat=remat, remat_policy=policy)
        params = params_from_jax(cfg, _np_tree(jparams), "cpu")
        leaves = _flat(params)
        for t in leaves.values():
            t.requires_grad_(True)
        loss, met = tllama.loss_fn(
            cfg, params, torch.from_numpy(b["tokens"]),
            torch.from_numpy(b["targets"]), torch.from_numpy(b["mask"]))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        results.append((loss, met, dict(zip(leaves, grads))))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=0,
                                   atol=1e-5)
        for k in ("loss", "z_loss", "accuracy"):
            np.testing.assert_allclose(met[k].item(), float(jmet[k]),
                                       rtol=0, atol=1e-5)
        assert set(jflat) == set(results[-1][2])
        for name, g in results[-1][2].items():
            np.testing.assert_allclose(_as_np(g), jflat[name], rtol=0,
                                       atol=1e-5, err_msg=name)
    for _, _, grads in results[1:]:
        for name, g in grads.items():
            assert torch.equal(g, results[0][2][name]), name


def _run_steps(tc_kw, n_steps=5, masked=False, chunk=0):
    jcfg, tcfg = _cfgs(xent_chunk=chunk)
    jtc = jts.TrainConfig(**tc_kw)
    ttc = tts.TrainConfig(**tc_kw)
    jopt = jts.make_optimizer(jtc)
    jstate = jts.init_train_state(jcfg, jopt, jax.random.PRNGKey(0),
                                  jtc.param_dtype)
    tstate = state_from_jax(tcfg, _np_tree(jstate), "cpu")
    jstep = jts.make_train_step(jcfg, jtc, jopt)
    tstep = tts.make_train_step(tcfg, ttc, tts.make_optimizer(ttc))
    for i in range(n_steps):
        b = _batch(10 + i, jcfg.vocab_size, masked=masked)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        for k in ("total_loss", "loss", "z_loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=0,
                                       atol=1e-5, err_msg=f"step {i} {k}")
    return jcfg, tcfg, jstate, tstate, jm


def _assert_state_close(tcfg, jstate, tstate, rel):
    want = state_from_jax(tcfg, _np_tree(jstate), "cpu")
    assert tstate["step"] == want["step"]
    assert tstate["opt_state"]["count"] == want["opt_state"]["count"]
    for part, got, exp in (("params", tstate["params"], want["params"]),
                           ("mu", tstate["opt_state"]["mu"],
                            want["opt_state"]["mu"]),
                           ("nu", tstate["opt_state"]["nu"],
                            want["opt_state"]["nu"])):
        g, e = _flat(got), _flat(exp)
        for name in e:
            assert g[name].dtype == e[name].dtype, (part, name)
            scale = max(e[name].abs().max().item(), 1e-30)
            np.testing.assert_allclose(_as_np(g[name]), _as_np(e[name]),
                                       rtol=0, atol=rel * scale,
                                       err_msg=f"{part} {name}")


@pytest.mark.parametrize("case", [
    dict(tc={}, masked=False, chunk=0, clipped=True),
    dict(tc={"grad_accum": 2}, masked=True, chunk=0, clipped=True),
    dict(tc={"grad_clip": 100.0}, masked=False, chunk=96, clipped=False),
], ids=["clip-triggers", "accum2-ragged-mask", "no-clip-chunked"])
def test_train_steps_match_jax(case):
    """The default clip (1.0) triggers here: the gradient norm of these
    steps is about 5."""
    tc_kw = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=10,
                 **case["tc"])
    _, tcfg, jstate, tstate, jm = _run_steps(tc_kw, masked=case["masked"],
                                             chunk=case["chunk"])
    clip = tc_kw.get("grad_clip", 1.0)
    assert (float(jm["grad_norm"]) > clip) == case["clipped"]
    _assert_state_close(tcfg, jstate, tstate, 1e-5)


@pytest.mark.parametrize("warmup,decay", [(2, 10), (5, 5), (12, 4), (0, 1),
                                          (3, 1)])
def test_schedule_matches_optax(warmup, decay):
    """The learning rate at counts 0..12, including warmup >= decay (the
    JAX package clamps the warmup to decay - 1)."""
    lr = 3e-4
    w = min(warmup, max(0, decay - 1))
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=lr, warmup_steps=w,
        decay_steps=max(decay, w + 1), end_value=lr * 0.1)
    opt = tts.make_optimizer(tts.TrainConfig(learning_rate=lr,
                                             warmup_steps=warmup,
                                             decay_steps=decay))
    got = [opt.schedule(c) for c in range(13)]
    want = [float(sched(c)) for c in range(13)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert got[0] == 0.0 or w == 0


def test_mixed_precision_step_matches_jax():
    """bf16 compute with f32 masters: the gradients and the Adam state come
    back in f32; one step against JAX at bf16 tolerance."""
    jcfg, tcfg = _cfgs(jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    kw = dict(learning_rate=1e-2, warmup_steps=0, decay_steps=10,
              param_dtype="float32")
    jtc, ttc = jts.TrainConfig(**kw), tts.TrainConfig(**kw)
    jopt = jts.make_optimizer(jtc)
    jstate = jts.init_train_state(jcfg, jopt, jax.random.PRNGKey(0),
                                  "float32")
    tstate = state_from_jax(tcfg, _np_tree(jstate), "cpu")
    assert all(t.dtype == torch.float32
               for t in _flat(tstate["params"]).values())
    b = _batch(3, jcfg.vocab_size)
    jstate, jm = jts.make_train_step(jcfg, jtc, jopt)(
        jstate, {k: jnp.asarray(v) for k, v in b.items()})
    tstate, tm = tts.make_train_step(tcfg, ttc, tts.make_optimizer(ttc))(
        tstate, {k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=2e-2)
    # bf16 rounds at other places in the two frameworks (XLA rounds once
    # per fusion, torch once per op).  JAX's own bf16 gradients of this
    # batch differ from its f32 gradients by 0.5-1.6% in relative norm
    # (leaf by leaf), so the moments are held to twice that: mu (0.1 g)
    # 3e-2, nu (0.05 g^2) 5e-2.  The first Adam update is lr * sign(g), so
    # a near-zero gradient whose sign differs moves a master by at most
    # 2 lr (1 + wd |p|): the masters are held to that, elementwise.
    jadam = jstate["opt_state"][1][0]
    for got, want, tol in ((tstate["opt_state"]["mu"], jadam.mu, 3e-2),
                           (tstate["opt_state"]["nu"], jadam.nu, 5e-2)):
        want = _flat(_np_tree(want))
        for name, g in _flat(got).items():
            assert g.dtype == torch.float32
            w = np.asarray(want[name], np.float32)
            err = np.linalg.norm(_as_np(g) - w) / max(np.linalg.norm(w),
                                                      1e-30)
            assert err <= tol, (name, err)
    want = _flat(_np_tree(jstate["params"]))
    for name, g in _flat(tstate["params"]).items():
        assert g.dtype == torch.float32
        w = np.asarray(want[name], np.float32)
        bound = 2 * kw["learning_rate"] * (1 + 0.1 * np.abs(w)) + 1e-6
        assert (np.abs(_as_np(g) - w) <= bound).all(), name
