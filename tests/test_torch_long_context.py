"""PyTorch port, the long-context training path vs the JAX package on
``llama_tiny``: ring attention in the model and the sequence-parallel
train step.

- ``llama.forward`` with ``attn_impl="ring"`` and ``"ring_rdma"`` over
  ``LocalRing(4)`` against JAX ``llama.forward(RING_CFG, params, tokens,
  mesh)`` on a 4-device sp mesh, from the same parameters
  (``models/convert.py``); without a mesh the ring raises ``ValueError``.
- 3 steps of ``make_sharded_train_fns`` on ``LocalRing(4)`` against JAX's
  ``make_sharded_train_fns`` on that mesh: per-step metrics and the
  parameters after 3 steps, for the plain ring, the kernel ring, and the
  kernel ring with full remat and 2-way gradient accumulation; masks that
  leave the shards unequally full, so the loss is a global mean and not a
  mean of shard means.  Remat gives the same gradients as none.
- The same over a 4-process gloo ``DeviceMesh`` (``torch_sp_worker.py``):
  every rank's logits shard, every rank's metrics and parameters (all
  ranks alike).

Tolerances: float32 1e-5 absolute for logits, losses, metrics, gradient
norms and the parameters after 3 steps (measured: at most 6.6e-6, on an
embedding entry whose Adam update, at lr 1e-2, scales the two packages'
last-bit gradient differences up; ``test_torch_train.py`` holds the
non-ring step at 1e-5 of each leaf's largest value, 4.8e-6 for the
embedding).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuberay_tpu.models import llama as jllama
from kuberay_tpu.parallel.mesh import MeshSpec as JMeshSpec
from kuberay_tpu.train import train_step as jts
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.models.convert import params_from_jax
from kuberay_tpu_torch.parallel.mesh import LocalRing
from kuberay_tpu_torch.train import train_step as tts

import torch_sp_worker

torch.set_num_threads(2)

JBASE = jllama.CONFIGS["llama_tiny"]
RING_CFG = dataclasses.replace(JBASE, attn_impl="ring")
TBASE = tllama.CONFIGS["llama_tiny"]
B, S, SP, STEPS = 2, 64, 4, 3
TC = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=10)
VARIANTS = [
    {"name": "ring", "attn": "ring", "remat": False, "tc": TC},
    {"name": "ring_rdma", "attn": "ring_rdma", "remat": False, "tc": TC},
    {"name": "ring_rdma_remat_accum2", "attn": "ring_rdma", "remat": True,
     "tc": {**TC, "grad_accum": 2}},
]
PARAM_ATOL = 1e-5
METRICS = ("total_loss", "loss", "z_loss", "accuracy", "grad_norm")


def _batches():
    rng = np.random.default_rng(5)
    out = {}
    for i in range(STEPS):
        out[f"tokens_{i}"] = rng.integers(0, JBASE.vocab_size, (B, S)
                                          ).astype(np.int32)
        out[f"targets_{i}"] = rng.integers(0, JBASE.vocab_size, (B, S)
                                           ).astype(np.int32)
        mask = (rng.uniform(size=(B, S)) > 0.2).astype(np.float32)
        mask[0, 3 * S // 4:] = 0.0         # row 0's last shard is empty
        mask[1, :S // 4] *= rng.uniform(size=S // 4) > 0.7
        out[f"mask_{i}"] = mask
    return out


def _flat(tree, prefix=""):
    """{"layers/wq": array, ...} of a JAX (numpy) or a port (torch) tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
    return {prefix[:-1]: np.asarray(tree, dtype=np.float32)}


@pytest.fixture(scope="module")
def setup():
    mesh = JMeshSpec(dp=1, fsdp=1, tp=1, sp=SP).build(jax.devices()[:SP])
    params = jax.tree.map(np.asarray,
                          jllama.init_params(RING_CFG, jax.random.PRNGKey(0)))
    return mesh, params, _batches()


@pytest.fixture(scope="module")
def jax_runs(setup):
    """JAX's logits of step 0's tokens, and 3 sharded steps for each
    TrainConfig among the variants (metrics per step, final params)."""
    mesh, params, batches = setup
    logits = np.asarray(jllama.forward(
        RING_CFG, params, jnp.asarray(batches["tokens_0"]), mesh=mesh))
    runs = {}
    for var in VARIANTS:
        key = tuple(sorted(var["tc"].items()))
        if key in runs:
            continue
        init, step, _ = jts.make_sharded_train_fns(
            RING_CFG, jts.TrainConfig(**var["tc"]), mesh)
        state = init(jax.random.PRNGKey(0))
        metrics = []
        for i in range(STEPS):
            state, m = step(state, {k: jnp.asarray(batches[f"{k}_{i}"])
                                    for k in ("tokens", "targets", "mask")})
            metrics.append({k: float(m[k]) for k in METRICS})
        runs[key] = (metrics, _flat(jax.tree.map(np.asarray,
                                                 state["params"])))
    return logits, runs


def _jax_run(jax_runs, var):
    return jax_runs[1][tuple(sorted(var["tc"].items()))]


def _assert_params_close(got: dict, want: dict, name: str):
    assert set(got) == set(want)
    for leaf, w in want.items():
        np.testing.assert_allclose(got[leaf], w, rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"{name} {leaf}")


def _tcfg(var):
    return dataclasses.replace(TBASE, attn_impl=var["attn"],
                               remat=var["remat"])


@pytest.mark.parametrize("var", VARIANTS[:2], ids=lambda v: v["name"])
def test_forward_on_local_ring_matches_jax(setup, jax_runs, var):
    _, params, batches = setup
    cfg = _tcfg(var)
    with torch.no_grad():
        got = tllama.forward(cfg, params_from_jax(cfg, params, "cpu"),
                             torch.from_numpy(batches["tokens_0"]),
                             mesh=LocalRing(SP, "cpu"))
    np.testing.assert_allclose(got.numpy(), jax_runs[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("attn", ["ring", "ring_rdma"])
def test_ring_requires_mesh(setup, attn):
    _, params, batches = setup
    cfg = dataclasses.replace(TBASE, attn_impl=attn)
    with pytest.raises(ValueError, match="requires forward"):
        tllama.forward(cfg, params_from_jax(cfg, params, "cpu"),
                       torch.from_numpy(batches["tokens_0"]))


def test_remat_gives_the_ring_the_same_gradients(setup):
    """Full remat reruns the kernel ring's forward, exchange included, in
    the backward: the gradients are bit for bit those without remat."""
    _, params, batches = setup
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(TBASE, attn_impl="ring_rdma", remat=remat)
        p = params_from_jax(cfg, params, "cpu")
        leaves = [p["embed"], *p["layers"].values()]
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = tllama.loss_fn(cfg, p, torch.from_numpy(batches["tokens_0"]),
                                 torch.from_numpy(batches["targets_0"]),
                                 torch.from_numpy(batches["mask_0"]),
                                 mesh=LocalRing(SP, "cpu"))
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("var", VARIANTS, ids=lambda v: v["name"])
def test_sharded_steps_on_local_ring_match_jax(setup, jax_runs, var):
    _, params, batches = setup
    cfg = _tcfg(var)
    tc = tts.TrainConfig(**var["tc"])
    _, step, shardings = tts.make_sharded_train_fns(cfg, tc,
                                                    LocalRing(SP, "cpu"))
    assert shardings["params"] == "replicated over sp"
    p = params_from_jax(cfg, params, "cpu")
    state = {"step": 0, "params": p,
             "opt_state": tts.make_optimizer(tc).init(p)}
    want_metrics, want_params = _jax_run(jax_runs, var)
    for i in range(STEPS):
        state, m = step(state, {k: torch.from_numpy(batches[f"{k}_{i}"])
                                for k in ("tokens", "targets", "mask")})
        for k in METRICS:
            np.testing.assert_allclose(m[k].item(), want_metrics[i][k],
                                       rtol=0, atol=1e-5,
                                       err_msg=f"step {i} {k}")
    assert state["step"] == STEPS
    _assert_params_close(_flat(state["params"]), want_params, var["name"])


def test_sharded_init_is_seeded_on_the_ring_device():
    tc = tts.TrainConfig()
    init, _, _ = tts.make_sharded_train_fns(TBASE, tc, LocalRing(SP, "cpu"))
    a, b = init(), init(torch.Generator().manual_seed(0))
    assert a["params"]["embed"].device.type == "cpu"
    assert torch.equal(a["params"]["embed"], b["params"]["embed"])
    assert a["opt_state"]["count"] == 0


@pytest.fixture(scope="module")
def gloo_train(setup, tmp_path_factory):
    _, params, batches = setup
    arrays = {**batches,
              **{f"params/{k}": v for k, v in _flat(params).items()}}
    return torch_sp_worker.spawn(
        {"kind": "train", "steps": STEPS, "variants": VARIANTS}, arrays,
        tmp_path_factory.mktemp("sp_train"))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("var", VARIANTS[:2], ids=lambda v: v["name"])
def test_gloo_forward_matches_jax(gloo_train, jax_runs, var):
    got = np.concatenate([o[f"{var['name']}_logits"] for o in gloo_train],
                         axis=1)
    np.testing.assert_allclose(got, jax_runs[0], rtol=0, atol=1e-5)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("var", VARIANTS, ids=lambda v: v["name"])
def test_gloo_sharded_steps_match_jax(gloo_train, jax_runs, var):
    want_metrics, want_params = _jax_run(jax_runs, var)
    name = var["name"]
    for rank, out in enumerate(gloo_train):
        for i in range(STEPS):
            for k in METRICS:
                np.testing.assert_allclose(
                    float(out[f"{name}_step{i}_{k}"]), want_metrics[i][k],
                    rtol=0, atol=1e-5, err_msg=f"rank {rank} step {i} {k}")
        got = {k[len(name) + 8:]: v for k, v in out.items()
               if k.startswith(f"{name}_params/")}
        _assert_params_close(got, want_params, f"{name} rank {rank}")


@pytest.mark.timeout(120)
def test_gloo_ranks_agree_and_refuse_attention_off_the_ring(gloo_train):
    """Replicated parameters stay identical on every rank; a DeviceMesh
    with attention that is not the ring is refused."""
    for out in gloo_train[1:]:
        for k, v in out.items():
            if "_params/" in k:
                assert np.array_equal(v, gloo_train[0][k]), k
    assert [int(o["non_ring_refused"]) for o in gloo_train] == [1, 1, 1, 1]
