"""PyTorch port, pipeline parallelism vs the JAX package's
``parallel/pipeline.py``: ``tests/test_pipeline.py``'s four tests on 4
gloo ranks of ``torch_pp_worker.py`` (one spawn for the module), each held
to JAX's ``pipeline_apply`` on 4 (or 2) of the virtual CPU devices,
computed in this process while the ranks run:

- outputs of the ``tanh(h @ w + b)`` stack (8 layers, d 16, batch 8) over
  pp=4 at 4 and 8 microbatches, on every rank, within 1e-5 (and over a
  mesh whose pp is 1);
- the gradients of ``(out ** 2).sum()`` in the stack, each stage's rows
  from the rank that holds it (zeros elsewhere), within 1e-4;
- ``llama_tiny``'s layers (``llama._layer``) at 2 stages, 2
  microbatches, within 2e-3 (every rank of the (pp=2, fsdp=2) mesh);
- the two ``ValueError``s with JAX's texts.

The dry run's pipeline line is held to JAX's in
``test_torch_multihost_serve.py`` (4 ranks) and
``test_torch_entry_bench.py`` (8 ranks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuberay_tpu.models import llama as jllama
from kuberay_tpu.ops.rope import rope_frequencies
from kuberay_tpu.parallel.mesh import MeshSpec
from kuberay_tpu.parallel.pipeline import pipeline_apply

import torch_pp_worker

torch.set_num_threads(2)

WORLD = 4
N_MICRO = [4, 8]
CFG = jllama.CONFIGS["llama_tiny"]


def simple_layer(h, lp):
    return jnp.tanh(h @ lp["w"] + lp["b"])


def make_stack(n_layers=8, d=16, seed=0):
    k = jax.random.split(jax.random.PRNGKey(seed), 2)
    return {
        "w": jax.random.normal(k[0], (n_layers, d, d)) * 0.3,
        "b": jax.random.normal(k[1], (n_layers, d)) * 0.1,
    }


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, dtype=np.float32)}


def _errors(mesh, x):
    out = []
    for stack, kw in ((make_stack(n_layers=6), {}),
                      (make_stack(), {"n_microbatches": 3})):
        with pytest.raises(ValueError) as e:
            pipeline_apply(simple_layer, stack, x, mesh, **kw)
        out.append(str(e.value))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    stack = make_stack()
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 16))
    params = jllama.init_params(CFG, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                CFG.vocab_size)
    arrays = {"w": np.asarray(stack["w"]), "b": np.asarray(stack["b"]),
              "x": np.asarray(x), "tokens": np.asarray(tokens, np.int32)}
    arrays.update({f"llama/{k}": v for k, v in _flat(params).items()})
    collect = torch_pp_worker.spawn(
        {"n_micro": N_MICRO}, arrays, tmp_path_factory.mktemp("pp"),
        world=WORLD, wait=False)
    mesh4 = MeshSpec(pp=4, fsdp=1).build(jax.devices()[:4])
    want = {f"out_micro{n}": np.asarray(pipeline_apply(
        simple_layer, stack, x, mesh4, n_microbatches=n)) for n in N_MICRO}
    g = jax.grad(lambda s: (pipeline_apply(simple_layer, s, x, mesh4)
                            ** 2).sum())(stack)
    want["grad_w"], want["grad_b"] = np.asarray(g["w"]), np.asarray(g["b"])
    mesh2 = MeshSpec(pp=2, fsdp=1).build(jax.devices()[:2])
    h0 = jnp.take(params["embed"], tokens, axis=0)
    cos, sin = rope_frequencies(CFG.head_dim, 16, CFG.rope_theta)
    want["llama"] = np.asarray(pipeline_apply(
        lambda h, lp: jllama._layer(CFG, h, lp, cos, sin),
        params["layers"], h0, mesh2, n_microbatches=2))
    want["errors"] = _errors(mesh4, jnp.zeros((8, 16)))
    return {"outs": collect(), "want": want}


@pytest.mark.parametrize("n_micro", N_MICRO)
def test_pipeline_matches_jax(runs, n_micro):
    key = f"out_micro{n_micro}"
    for out in runs["outs"]:
        np.testing.assert_allclose(out[key], runs["want"][key],
                                   rtol=1e-5, atol=1e-5)


def test_one_stage_pipeline_matches_jax(runs):
    """A mesh whose pp is 1: every layer on each rank, no hops; JAX's
    4-stage result (the same function)."""
    for out in runs["outs"]:
        np.testing.assert_allclose(out["out_pp1"], runs["want"]["out_micro4"],
                                   rtol=1e-5, atol=1e-5)


def test_pipeline_gradients_match_jax(runs):
    """Each stage's rows from its rank, gathered over the stages; the
    other rows of a rank's gradient stay zero (a stage touches only its
    own layers)."""
    per = 8 // WORLD
    for name in ("grad_w", "grad_b"):
        got = np.zeros_like(runs["want"][name])
        for r, out in enumerate(runs["outs"]):
            rows = slice(r * per, (r + 1) * per)
            got[rows] = out[name][rows]
            rest = np.delete(out[name], np.arange(r * per, (r + 1) * per),
                             axis=0)
            assert not rest.any(), (r, name)
        np.testing.assert_allclose(got, runs["want"][name], rtol=1e-4,
                                   atol=1e-4)
    losses = [float(o["loss"]) for o in runs["outs"]]
    assert max(losses) - min(losses) == 0.0


def test_pipeline_llama_layers_match_jax(runs):
    for out in runs["outs"]:
        np.testing.assert_allclose(out["llama"], runs["want"]["llama"],
                                   rtol=2e-3, atol=2e-3)


def test_pipeline_validation_errors_match_jax(runs):
    for out in runs["outs"]:
        assert out["errors"].tolist() == runs["want"]["errors"]


@pytest.mark.gpu
def test_pipeline_phase_on_card():
    """``chip_smoke.py``'s ``pipeline`` phase: llama_1b's 16 layers as two
    stages of 8, one process a stage sharing the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import subprocess
    import chip_smoke
    from kuberay_tpu_torch.ops import _build
    _build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    run = chip_smoke.pipeline_phase(smi)
    assert all(r["out_bits_equal"] for r in run["ranks"])
