"""PyTorch port, sequence-parallel ring attention vs the JAX package.

- The ring step's plain version (``ops/ring_attention.py``, the building
  block of the ring kernel's plain version) against JAX's
  ``_block_attention`` plus the online merge (``parallel/ring.py``): a
  diagonal, a past, a future (state unchanged) and a ragged block (shard
  40, offsets not multiples of 8, rows that see nothing), causal and not,
  carrying the state or normalising it at the last step.
- ``ring_attention`` with both impls over ``LocalRing(4)`` against JAX's
  ppermute and interpret-mode Pallas (``rdma_interpret``) rings on a
  4-device mesh: forward and the gradients of sum(out * w), causal and
  not, GQA 4/2.
- The same over a 4-process gloo ``DeviceMesh`` (``torch_sp_worker.py``:
  the children import torch only; the JAX reference is computed here).
- ``MeshSpec.resolve`` against the JAX package's; a non-sp axis larger
  than 1 is refused.

Tolerances: float32 1e-5 absolute for the step and the forward,
5e-5 for gradients (summation order; the port's rdma backward runs the
flash backward's plain versions from the global lse, JAX differentiates
the ppermute ring).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kuberay_tpu.parallel import ring as jring
from kuberay_tpu.parallel.mesh import MeshSpec as JMeshSpec
from kuberay_tpu_torch.ops import ring_attention as ra
from kuberay_tpu_torch.parallel.mesh import LocalRing, MeshSpec
from kuberay_tpu_torch.parallel.ring import ring_attention

import torch_sp_worker

torch.set_num_threads(2)

B, S, HQ, HKV, D, SP = 2, 32, 4, 2, 16, 4
SCALE = D ** -0.5
FWD_ATOL, GRAD_ATOL = 1e-5, 5e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------
# One ring step
# --------------------------------------------------------------------------

# (Sq = Skv, q_off, k_off, causal)
STEP_CASES = {
    "diagonal": (16, 32, 32, True),
    "past": (16, 32, 0, True),
    "future": (16, 16, 32, True),
    "ragged": (40, 83, 97, True),        # rows 83..96 see no key
    "noncausal": (16, 0, 48, False),
}


def _jax_step(q, k, v, acc, m, l, q_off, k_off, causal, last):
    """JAX's block attention and merge on the port's state layout."""
    pv, bm, bl = jring._block_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), SCALE, q_off, k_off,
        causal)
    mj = jnp.asarray(m).transpose(0, 2, 1)[..., None]      # [B, Sq, H, 1]
    lj = jnp.asarray(l).transpose(0, 2, 1)[..., None]
    m_new = jnp.maximum(mj, bm)
    c_old, c_new = jnp.exp(mj - m_new), jnp.exp(bm - m_new)
    acc = jnp.asarray(acc) * c_old + pv * c_new
    l_new = lj * c_old + bl * c_new
    back = (lambda x: np.asarray(x[..., 0].transpose(0, 2, 1)))
    if not last:
        return {"acc": np.asarray(acc), "m": back(m_new), "l": back(l_new)}
    l_new = jnp.where(l_new == 0.0, 1.0, l_new)
    return {"out": np.asarray(acc / l_new),
            "lse": back(m_new + jnp.log(l_new))}


@pytest.mark.parametrize("last", [False, True], ids=["carry", "last"])
@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_ref_matches_jax_block_and_merge(case, last):
    n, q_off, k_off, causal = STEP_CASES[case]
    rng = np.random.default_rng(1)
    q, k, v = _rand(rng, B, n, HQ, D), _rand(rng, B, n, HKV, D), \
        _rand(rng, B, n, HKV, D)
    # A carried state: the merge of an earlier block.
    acc = _rand(rng, B, n, HQ, D)
    m = _rand(rng, B, HQ, n) + 2.0
    l = rng.uniform(1.0, 5.0, (B, HQ, n)).astype(np.float32)
    want = _jax_step(q, k, v, acc, m, l, q_off, k_off, causal, last)
    st = {x: torch.from_numpy(a.copy()) for x, a in
          (("acc", acc), ("m", m), ("l", l))}
    res = {"out": torch.empty(B, n, HQ, D), "lse": torch.empty(B, HQ, n)}
    ra.ring_attention_step_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                               st["acc"], st["m"], st["l"], q_off, k_off,
                               causal, SCALE, last, res["out"], res["lse"])
    got = res if last else st
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=FWD_ATOL, err_msg=key)
    if last or case == "future":
        # Normalising leaves the state as it was; so does a block wholly in
        # the rows' future.
        for key, a in (("acc", acc), ("m", m), ("l", l)):
            assert np.array_equal(st[key].numpy(), a), key


def test_step_ref_from_the_empty_state_over_a_future_block():
    """A rank whose first block it cannot see: out 0 and lse -1e30, the
    TPU kernel's l == 0 guard."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(_rand(rng, 1, 8, 2, D))
    k = torch.from_numpy(_rand(rng, 1, 8, 2, D))
    acc, l = torch.zeros(1, 8, 2, D), torch.zeros(1, 2, 8)
    m = torch.full((1, 2, 8), -1e30)
    out, lse = torch.full((1, 8, 2, D), 7.0), torch.empty(1, 2, 8)
    ra.ring_attention_step_ref(q, k, k, acc, m, l, 0, 8, True, SCALE, True,
                               out, lse)
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.equal(lse, torch.full_like(lse, -1e30))


# --------------------------------------------------------------------------
# The whole ring
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qkvw():
    rng = np.random.default_rng(3)
    return {"q": _rand(rng, B, S, HQ, D), "k": _rand(rng, B, S, HKV, D),
            "v": _rand(rng, B, S, HKV, D), "w": _rand(rng, B, S, HQ, D)}


@pytest.fixture(scope="module")
def jax_ring(qkvw):
    """JAX's rings (ppermute and interpret-mode Pallas) over 4 devices:
    output and the gradients of sum(out * w)."""
    mesh = Mesh(np.array(jax.devices()[:SP]), ("sp",))
    q, k, v, w = (jnp.asarray(qkvw[x]) for x in "qkvw")
    res = {}
    for impl in ("ppermute", "rdma_interpret"):
        for causal in (True, False):
            def f(q, k, v, impl=impl, causal=causal):
                return jring.ring_attention(q, k, v, mesh, causal=causal,
                                            impl=impl)
            out = np.asarray(jax.jit(f)(q, k, v))
            grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * w),
                                     argnums=(0, 1, 2)))(q, k, v)
            res[impl, causal] = {"out": out, **{
                f"d{x}": np.asarray(g) for x, g in zip("qkv", grads)}}
    return res


def _port_ring(qkvw, impl, causal):
    q, k, v = (torch.from_numpy(qkvw[x]).requires_grad_() for x in "qkv")
    out = ring_attention(q, k, v, LocalRing(SP, "cpu"), causal=causal,
                         impl=impl)
    (out * torch.from_numpy(qkvw["w"])).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


def _assert_matches_both(got, jax_ring, causal, keys):
    for jimpl in ("ppermute", "rdma_interpret"):
        want = jax_ring[jimpl, causal]
        for key in keys:
            np.testing.assert_allclose(
                got[key], want[key], rtol=0,
                atol=FWD_ATOL if key == "out" else GRAD_ATOL,
                err_msg=f"{key} vs JAX {jimpl}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("impl", ["ppermute", "rdma"])
def test_local_ring_forward_matches_jax(qkvw, jax_ring, impl, causal):
    got = _port_ring(qkvw, impl, causal)
    _assert_matches_both(got, jax_ring, causal, ["out"])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("impl", ["ppermute", "rdma"])
def test_local_ring_gradients_match_jax(qkvw, jax_ring, impl, causal):
    got = _port_ring(qkvw, impl, causal)
    _assert_matches_both(got, jax_ring, causal, ["dq", "dk", "dv"])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_fwd_ref_matches_jax(qkvw, jax_ring, causal):
    """The ring kernel's plain version on every rank's shard at once (as a
    LocalRing holds them) against JAX's two rings."""
    ring = LocalRing(SP, "cpu")
    q, k, v = (ring.shard(torch.from_numpy(qkvw[x])) for x in "qkv")
    out, lse = ra.ring_attention_fwd(q, k, v, 0, SP, causal, SCALE)
    assert lse.shape == (SP, B, HQ, S // SP)
    _assert_matches_both({"out": ring.unshard(out).numpy()}, jax_ring,
                         causal, ["out"])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_fwd_ref_one_rank_over_the_n_slot_buffer(qkvw, causal):
    """One held rank (as a DeviceRing holds it) reading the K and V views of
    an n-slot buffer [n, 2, B, Sl, Hkv, D] gives that rank's rows of the
    all-ranks call, bit for bit."""
    ring = LocalRing(SP, "cpu")
    q, k, v = (ring.shard(torch.from_numpy(qkvw[x])) for x in "qkv")
    out, lse = ra.ring_attention_fwd(q, k, v, 0, SP, causal, SCALE)
    buf = torch.stack([k, v], dim=1)
    for r in range(SP):
        o1, l1 = ra.ring_attention_fwd(q[r:r + 1], buf[:, 0], buf[:, 1], r,
                                       SP, causal, SCALE)
        assert torch.equal(o1[0], out[r]) and torch.equal(l1[0], lse[r])


def test_local_ring_refuses_unequal_shards_and_unknown_impls(qkvw):
    q = torch.from_numpy(qkvw["q"])
    with pytest.raises(ValueError, match="equal sp shards"):
        ring_attention(q, q, q, LocalRing(3, "cpu"))
    with pytest.raises(ValueError, match="unknown ring impl"):
        ring_attention(q, q, q, LocalRing(SP, "cpu"), impl="rdma_interpret")


def test_local_ring_rotate_sends_right():
    ring = LocalRing(4, "cpu")
    x = torch.arange(4.0)[:, None].repeat(1, 3)
    assert ring.rotate(x)[:, 0].tolist() == [3.0, 0.0, 1.0, 2.0]
    assert ring.rotate(x, shift=-1)[:, 0].tolist() == [1.0, 2.0, 3.0, 0.0]
    assert ring.sum(x) is x


@pytest.fixture(scope="module")
def gloo_ring(qkvw, tmp_path_factory):
    """Each of 4 gloo ranks' outputs and gradients, gathered along S."""
    outs = torch_sp_worker.spawn({"kind": "ring"}, qkvw,
                                 tmp_path_factory.mktemp("sp_ring"))
    keys = [k for k in outs[0] if k != "non_sp_mesh_ring"]
    gathered = {k: np.concatenate([o[k] for o in outs], axis=1) for k in keys}
    return gathered, [o["non_sp_mesh_ring"].tolist() for o in outs]


@pytest.mark.timeout(120)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("impl", ["ppermute", "rdma"])
def test_gloo_ring_matches_jax(gloo_ring, jax_ring, impl, causal):
    got = {k.split("_")[-1]: v for k, v in gloo_ring[0].items()
           if k.startswith(f"{impl}_{causal}_")}
    _assert_matches_both(got, jax_ring, causal, ["out", "dq", "dk", "dv"])


@pytest.mark.timeout(120)
def test_gloo_mesh_refuses_non_sp_axes(gloo_ring):
    """Axes other than sp are no longer refused (the multi-process layouts
    are ported): MeshSpec(fsdp=2, sp=2) builds over the 4 ranks and its
    ring is the sp sub-mesh (rank r at sp coordinate r % 2)."""
    assert gloo_ring[1] == [[2, r % 2, 2] for r in range(4)]


# --------------------------------------------------------------------------
# MeshSpec
# --------------------------------------------------------------------------

@pytest.mark.parametrize("axes,n", [
    (dict(), 4), (dict(sp=4), 4), (dict(fsdp=1, sp=4), 4),
    (dict(dp=2, fsdp=-1, sp=2), 8), (dict(fsdp=-1, tp=-1), 4),
    (dict(fsdp=1, sp=3), 4), (dict(sp=3), 4),
])
def test_meshspec_resolve_matches_jax(axes, n):
    def run(cls):
        try:
            return cls(**axes).resolve(n)
        except ValueError as e:
            return ("ValueError", str(e))
    assert run(MeshSpec) == run(JMeshSpec)
    assert MeshSpec.AXES == JMeshSpec.AXES


