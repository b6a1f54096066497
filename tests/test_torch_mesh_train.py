"""PyTorch port, the multi-process training layouts vs the JAX package.

One set of 8 gloo ranks (``torch_mesh_worker.py``, started once for the
module while JAX computes its side) runs ``make_sharded_train_fns`` on
``llama_tiny`` (float32) from the JAX package's seed-0 params, 2 steps on
the same masked global batches (B 8 x S 16), under:

- ``MeshSpec(dp=2, fsdp=2, tp=2)``, also with ``grad_accum=2`` and with
  the chunked cross entropy (``xent_chunk=100``: vocab-parallel chunks
  over tp);
- ``MeshSpec(fsdp=4, tp=2)``;
- ``MeshSpec(dp=2, sp=2, tp=2)`` with ``attn_impl="ring"``;
- ``MeshSpec(dp=2, fsdp=-1, tp=2).build_multislice(2)``;

each against JAX's ``make_sharded_train_fns`` on the same mesh over the 8
virtual CPU devices: every step's loss, z-loss, accuracy, grad norm and
total loss, and every param leaf gathered to its global value, within
``atol=1e-5`` (the tolerance of ``test_torch_long_context.py``).  The
multi-slice mesh gives every rank the coordinate JAX gives its device,
and every param leaf's placements shard the dims JAX's shardings do.
``mixtral_tiny`` over ``MeshSpec(dp=-1, fsdp=2, ep=2)`` (experts over ep,
the capacity dispatch counted over the global batch): the forward's
logits and one step's loss, aux losses, accuracy and grad norm against
JAX's forward and ``value_and_grad`` of ``loss_fn`` on the same mesh.
The (dp 2, fsdp 2, tp 2) state saved by the 8 ranks restores into one
process and into the (fsdp 4, tp 2) layout bit for bit the gathered
state, and ``load_params_for_serving`` reads it.  The seeded ``init()`` lays out the seed's global params.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kuberay_tpu.models import llama as jllama
from kuberay_tpu.models import mixtral as jmixtral
from kuberay_tpu.parallel.mesh import DEFAULT_RULES as JRULES
from kuberay_tpu.parallel.mesh import MeshSpec as JMeshSpec
from kuberay_tpu.parallel.mesh import logical_to_sharding as jsharding
from kuberay_tpu.train import train_step as jts
from kuberay_tpu_torch.models import llama as tllama
from kuberay_tpu_torch.train import checkpoint as ckpt

import torch_mesh_worker

torch.set_num_threads(2)

CFG = jllama.CONFIGS["llama_tiny"]
B, S, STEPS, WORLD = 8, 16, 2, 8
TC = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=10)
ATOL = 1e-5
METRICS = ("total_loss", "loss", "z_loss", "accuracy", "grad_norm")
VARIANTS = [
    {"name": "dp2_fsdp2_tp2", "spec": dict(dp=2, fsdp=2, tp=2), "tc": TC,
     "save": True, "init": True},
    {"name": "dp2_fsdp2_tp2_accum2", "spec": dict(dp=2, fsdp=2, tp=2),
     "tc": {**TC, "grad_accum": 2}},
    {"name": "dp2_fsdp2_tp2_xent_chunk", "spec": dict(dp=2, fsdp=2, tp=2),
     "tc": TC, "cfg": {"xent_chunk": 100}},
    {"name": "fsdp4_tp2", "spec": dict(dp=1, fsdp=4, tp=2), "tc": TC,
     "restore": True},
    {"name": "dp2_sp2_tp2", "spec": dict(dp=2, fsdp=1, tp=2, sp=2),
     "tc": TC, "cfg": {"attn_impl": "ring"}},
    {"name": "multislice2", "spec": dict(dp=2, fsdp=-1, tp=2), "tc": TC,
     "slices": 2},
]
MCFG = jmixtral.CONFIGS["mixtral_tiny"]
MB, MS = 4, 16
MOE_TC = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=10)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, dtype=np.float32)}


def _inputs(params, mparams):
    rng = np.random.default_rng(11)
    arrays = {f"params/{k}": v for k, v in _flat(params).items()}
    arrays.update({f"moe_params/{k}": v for k, v in _flat(mparams).items()})
    for i in range(STEPS):
        arrays[f"tokens_{i}"] = rng.integers(0, CFG.vocab_size, (B, S)
                                             ).astype(np.int32)
        arrays[f"targets_{i}"] = rng.integers(0, CFG.vocab_size, (B, S)
                                              ).astype(np.int32)
        mask = (rng.uniform(size=(B, S)) > 0.2).astype(np.float32)
        mask[0, S // 2:] = 0.0
        mask[5, :] *= rng.uniform(size=S) > 0.7
        arrays[f"mask_{i}"] = mask
    arrays["moe_tokens"] = rng.integers(0, MCFG.vocab_size, (MB, MS)
                                        ).astype(np.int32)
    arrays["moe_targets"] = rng.integers(0, MCFG.vocab_size, (MB, MS)
                                         ).astype(np.int32)
    return arrays


def _jax_mesh(var):
    devices = jax.devices()[:WORLD]
    spec = JMeshSpec(**var["spec"])
    if var.get("slices"):
        return spec.build_multislice(devices, num_slices=var["slices"])
    return spec.build(devices)


def _jax_runs(arrays):
    runs = {}
    for var in VARIANTS:
        cfg = dataclasses.replace(CFG, **var.get("cfg", {}))
        mesh = _jax_mesh(var)
        init, step, _ = jts.make_sharded_train_fns(
            cfg, jts.TrainConfig(**var["tc"]), mesh)
        state = init(jax.random.PRNGKey(0))
        metrics = []
        for i in range(STEPS):
            state, m = step(state, {k: jnp.asarray(arrays[f"{k}_{i}"])
                                    for k in ("tokens", "targets", "mask")})
            metrics.append({k: float(m[k]) for k in METRICS})
        coords = {int(d.id): tuple(int(c) for c in np.argwhere(
            mesh.devices == d)[0]) for d in mesh.devices.flat}
        runs[var["name"]] = (metrics, _flat(jax.tree.map(
            np.asarray, state["params"])), coords)
    return runs


def _jax_moe(mparams, arrays):
    mesh = JMeshSpec(dp=-1, fsdp=2, ep=2).build(jax.devices()[:WORLD])
    sh = jax.tree.map(lambda a: jsharding(JRULES, mesh, a),
                      jmixtral.param_axes(MCFG),
                      is_leaf=lambda x: isinstance(x, tuple))
    p = jax.device_put(mparams, sh)
    tokens = jnp.asarray(arrays["moe_tokens"])
    targets = jnp.asarray(arrays["moe_targets"])
    logits, _ = jax.jit(lambda p, t: jmixtral.forward(MCFG, p, t))(p, tokens)
    (_, m), grads = jax.jit(jax.value_and_grad(
        lambda p: jmixtral.loss_fn(MCFG, p, tokens, targets),
        has_aux=True))(p)
    m = {k: float(v) for k, v in m.items()}
    m["grad_norm"] = float(optax.global_norm(grads))
    return np.asarray(logits), m


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = jax.tree.map(np.asarray,
                          jllama.init_params(CFG, jax.random.PRNGKey(0)))
    mparams = jax.tree.map(np.asarray,
                           jmixtral.init_params(MCFG, jax.random.PRNGKey(5)))
    arrays = _inputs(params, mparams)
    root = tmp_path_factory.mktemp("mesh_train")
    task = {"kind": "train", "variants": VARIANTS, "steps": STEPS,
            "ckpt_dir": str(root / "ckpt"), "moe_tc": MOE_TC}
    wait = torch_mesh_worker.spawn(task, arrays, root, WORLD, wait=False)
    jax_side = _jax_runs(arrays), _jax_moe(mparams, arrays)
    return wait(), jax_side, root / "ckpt"


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", [v["name"] for v in VARIANTS])
def test_layout_steps_match_jax(runs, name):
    outs, (jruns, _), _ = runs
    jmetrics, jparams, _ = jruns[name]
    for i in range(STEPS):
        for k in METRICS:
            got = [float(o[f"{name}_step{i}_{k}"]) for o in outs]
            np.testing.assert_allclose(got, jmetrics[i][k], rtol=0,
                                       atol=ATOL, err_msg=f"step {i} {k}")
    prefix = f"{name}_params/"
    got = {k[len(prefix):]: v for k, v in outs[0].items()
           if k.startswith(prefix)}
    assert set(got) == set(jparams)
    for k, v in jparams.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=ATOL, err_msg=k)
        for o in outs[1:]:                   # every rank gathers the same
            np.testing.assert_array_equal(o[prefix + k], got[k])


def _jax_placements(mesh, axes_tree, prefix=""):
    """{leaf: "axis=R" or "axis=S<dim>" a mesh axis} of JAX's
    ``logical_to_sharding`` under ``DEFAULT_RULES``."""
    if isinstance(axes_tree, dict):
        out = {}
        for k, v in axes_tree.items():
            out.update(_jax_placements(mesh, v, f"{prefix}{k}/"))
        return out
    spec = jsharding(JRULES, mesh, axes_tree).spec
    enc = []
    for a in mesh.axis_names:
        dims = [d for d, e in enumerate(spec)
                if a in ((e,) if isinstance(e, str) else e or ())]
        enc.append(f"{a}=S{dims[0]}" if dims and mesh.shape[a] > 1
                   else f"{a}=R")
    return {prefix[:-1]: ",".join(enc)}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", [v["name"] for v in VARIANTS] + ["moe"])
def test_leaf_placements_match_jax_shardings(runs, name):
    """Every param leaf's ``LeafSpec.placements`` (``logical_to_sharding``
    on the DeviceMesh) shards the dims JAX's NamedSharding does, over the
    same mesh axes."""
    outs = runs[0]
    if name == "moe":
        mesh = JMeshSpec(dp=-1, fsdp=2, ep=2).build(jax.devices()[:WORLD])
        want = _jax_placements(mesh, jmixtral.param_axes(MCFG))
    else:
        var = next(v for v in VARIANTS if v["name"] == name)
        cfg = dataclasses.replace(CFG, **var.get("cfg", {}))
        want = _jax_placements(_jax_mesh(var), jllama.param_axes(cfg))
    prefix = f"{name}_placements/"
    for o in outs:
        got = {k[len(prefix):]: str(v) for k, v in o.items()
               if k.startswith(prefix)}
        assert got == want
    assert any("=S" in v for v in want.values())


@pytest.mark.timeout(300)
def test_multislice_ranks_take_jax_coordinates(runs):
    outs, (jruns, _), _ = runs
    coords = jruns["multislice2"][2]
    for rank, o in enumerate(outs):
        assert tuple(o["multislice2_coord"]) == coords[rank], rank
    # dp crosses the slices: ranks 0-3 are slice 0, 4-7 slice 1.
    assert [int(o["multislice2_coord"][0]) for o in outs] == [0] * 4 + [1] * 4


@pytest.mark.timeout(300)
def test_mixtral_ep_forward_matches_jax(runs):
    outs, (_, (jlogits, _)), _ = runs
    rows = MB // 4
    for o in outs:
        r = int(o["moe_rows"])
        np.testing.assert_allclose(o["moe_logits"],
                                   jlogits[r * rows:(r + 1) * rows],
                                   rtol=0, atol=ATOL)


@pytest.mark.timeout(300)
def test_mixtral_ep_step_matches_jax_loss(runs):
    outs, (_, (_, jm)), _ = runs
    for k in ("loss", "total_loss", "aux_load_balance", "aux_router_z",
              "accuracy", "grad_norm"):
        got = [float(o[f"moe_{k}"]) for o in outs]
        np.testing.assert_allclose(got, jm[k], rtol=0, atol=ATOL, err_msg=k)


def _gathered(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


@pytest.mark.timeout(300)
def test_sharded_save_restores_into_one_process_bit_for_bit(runs):
    outs, _, ckpt_dir = runs
    name = "dp2_fsdp2_tp2"
    cfg = tllama.CONFIGS["llama_tiny"]
    shapes = tllama.init_params(cfg, None, "meta")

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else
                torch.zeros(v.shape, dtype=v.dtype) for k, v in tree.items()}

    template = {"step": 0, "params": zeros(shapes),
                "opt_state": {"count": 0, "mu": zeros(shapes),
                              "nu": zeros(shapes)}}
    state = ckpt.restore(str(ckpt_dir), STEPS, template)
    assert state["step"] == STEPS and state["opt_state"]["count"] == STEPS
    for part, tree in (("params", state["params"]),
                       ("mu", state["opt_state"]["mu"]),
                       ("nu", state["opt_state"]["nu"])):
        want = _gathered(outs[0], f"{name}_{part}/")
        got = _flat(tree)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.timeout(300)
def test_sharded_save_restores_into_another_layout_bit_for_bit(runs):
    outs, _, _ = runs
    want = _gathered(outs[0], "dp2_fsdp2_tp2_params/")
    for o in outs:
        assert int(o["fsdp4_tp2_restored_step"]) == STEPS
        got = _gathered(o, "fsdp4_tp2_restored/")
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.timeout(300)
def test_load_params_for_serving_reads_a_sharded_save(runs):
    outs, (jruns, _), ckpt_dir = runs
    name = "dp2_fsdp2_tp2"
    params = ckpt.load_params_for_serving(str(ckpt_dir), device="cpu")
    got = {k: v.numpy() for k, v in _flat_t(params).items()}
    want = _gathered(outs[0], f"{name}_params/")
    jparams = jruns[name][1]
    assert set(got) == set(want) == set(jparams)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got[k], jparams[k], rtol=0, atol=ATOL)


def _flat_t(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_t(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.timeout(300)
def test_seeded_init_lays_out_the_seed_params(runs):
    outs, _, _ = runs
    cfg = tllama.CONFIGS["llama_tiny"]
    seed = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = {k: v.numpy() for k, v in _flat_t(seed).items()}
    for o in outs:
        got = _gathered(o, "dp2_fsdp2_tp2_init/")
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
