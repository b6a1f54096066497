"""PyTorch port, ops: RMSNorm, RoPE and decode attention vs the JAX package.

Inputs come from numpy with a fixed seed and go to both packages.  The
port's wrappers take their plain versions here (CPU tensors); the kernels
themselves are checked by the ``gpu`` tests below and by chip_smoke.py.
"""

import jax  # noqa: F401  (both frameworks in one process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuberay_tpu.ops.decode_attention import (
    decode_attention_pallas,
    decode_attention_xla,
)
from kuberay_tpu.ops.rmsnorm import rmsnorm_xla
from kuberay_tpu.ops.rope import apply_rope as jax_apply_rope
from kuberay_tpu.ops.rope import rope_frequencies as jax_rope_frequencies
from kuberay_tpu_torch.ops import decode_attention as tda
from kuberay_tpu_torch.ops import rmsnorm as trn
from kuberay_tpu_torch.ops import rope as trope

torch.set_num_threads(2)

# float32: summation order only.  bf16 RMSNorm: one bf16 ulp at |y| < 4
# (inputs are drawn so |y| stays there).  bf16 decode: the Pallas kernel
# rounds probabilities to bf16 before P @ V, the port keeps them float32.
TOL = {"float32": {"rms": 1e-5, "decode": 1e-5},
       "bfloat16": {"rms": 1.6e-2, "decode": 2e-2}}


def _pair(a: np.ndarray, dtype: str):
    """The same numpy values as a JAX array and a torch tensor of dtype."""
    j = jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype))
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        getattr(torch, dtype))
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(256, 128), (512, 64), (300, 128),
                                    (7, 96)])
def test_rmsnorm_matches_jax(dtype, rows, d):
    """Row counts that are (256, 512) and are not (300, 7) multiples of the
    TPU kernel's 256-row block."""
    rng = np.random.default_rng(rows + d)
    x = rng.uniform(-1, 1, (rows, d))
    w = rng.uniform(0.5, 1.5, (d,))
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype)
    want = _np(rmsnorm_xla(jx, jw, 1e-5))
    got = trn.rmsnorm(tx, tw, 1e-5)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=TOL[dtype]["rms"])
    assert torch.equal(got, trn.rmsnorm_ref(tx, tw, 1e-5))


def test_rmsnorm_keeps_leading_axes():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 32))
    w = rng.normal(size=(32,))
    jx, tx = _pair(x, "float32")
    jw, tw = _pair(w, "float32")
    np.testing.assert_allclose(_np(trn.rmsnorm(tx, tw)),
                               _np(rmsnorm_xla(jx, jw)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_with_positions_matches_jax(dtype):
    D, max_len = 16, 64
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 3, D))
    pos = rng.integers(0, max_len, (2, 5))
    jcos, jsin = jax_rope_frequencies(D, max_len, 500000.0)
    tcos, tsin = trope.rope_frequencies(D, max_len, 500000.0)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-6)
    jx, tx = _pair(x, dtype)
    want = jax_apply_rope(jx, jcos, jsin, jnp.asarray(pos))
    got = trope.apply_rope(tx, tcos, tsin, torch.from_numpy(pos))
    assert got.dtype == tx.dtype
    # float32 math on both sides, one rounding to the working dtype.
    atol = 1e-5 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)
    # positions=None is arange(seq).
    np.testing.assert_allclose(
        _np(trope.apply_rope(tx, tcos, tsin)),
        _np(jax_apply_rope(jx, jcos, jsin)), rtol=0, atol=atol)


def _decode_inputs(S, Hq, Hkv, D, M, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(S, Hq, D)), rng.normal(size=(S, M, Hkv, D)),
            rng.normal(size=(S, M, Hkv, D)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (8, 2), (4, 4)])   # GQA, MHA
def test_decode_matches_pallas_interpret(dtype, Hq, Hkv):
    """All slots, incl. an idle one (lens=0 -> 0, as the TPU kernel)."""
    S, D, M = 5, 16, 48
    q, ck, cv = _decode_inputs(S, Hq, Hkv, D, M, seed=Hq * 10 + Hkv)
    lens = np.array([0, 1, 16, 17, 48], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, ck, cv))
    want = decode_attention_pallas(jq, jk, jv, jnp.asarray(lens), bkv=16,
                                   interpret=True)
    got = tda.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=TOL[dtype]["decode"])
    assert not _np(got)[0].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv,M", [(4, 2, 40), (4, 4, 50)])
def test_decode_matches_xla_on_live_slots(dtype, Hq, Hkv, M):
    """vs the XLA reference, including a cache length no block divides.
    The reference averages V over the whole cache for a lens=0 slot where
    the kernel (and the port) give 0: idle slots are discarded by the
    engine, so parity is held on live slots and the 0 is pinned."""
    S, D = 4, 16
    q, ck, cv = _decode_inputs(S, Hq, Hkv, D, M, seed=M)
    lens = np.array([0, 3, M // 2, M], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, ck, cv))
    want = _np(decode_attention_xla(jq, jk, jv, jnp.asarray(lens)))
    got = _np(tda.decode_attention(tq, tk, tv, torch.from_numpy(lens)))
    np.testing.assert_allclose(got[1:], want[1:], rtol=0,
                               atol=TOL[dtype]["decode"])
    assert not got[0].any()
    assert np.abs(want[0]).max() > 0       # the reference's differing choice


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    """On the card: the Triton RMSNorm and the CUDA decode kernel vs their
    plain versions at the Llama-3-8B decode shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.rand(300, 4096, generator=g, device="cuda") * 2 - 1).bfloat16()
    w = (torch.rand(4096, generator=g, device="cuda") + 0.5).bfloat16()
    err = (trn.rmsnorm(x, w).float() - trn.rmsnorm_ref(x, w).float()).abs()
    assert err.max().item() <= 1.6e-2
    for M, lens in ((2048, [0, 1, 17, 100, 1023, 1025, 2047, 2048]),
                    (1000, [0, 1, 63, 64, 65, 500, 999, 1000])):
        q = torch.randn(8, 32, 128, generator=g, device="cuda").bfloat16()
        ck = torch.randn(8, M, 8, 128, generator=g, device="cuda").bfloat16()
        cv = torch.randn(8, M, 8, 128, generator=g, device="cuda").bfloat16()
        lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
        before = tda.launches
        got = tda.decode_attention(q, ck, cv, lt)
        assert tda.launches == before + 1
        want = tda.decode_attention_ref(q, ck, cv, lt)
        assert (got.float() - want.float()).abs().max().item() <= 2e-2
        assert not got[0].any()
