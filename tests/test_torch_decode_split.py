"""PyTorch port, the decode kernels' split-and-merge: the plain models
``*_split_ref`` (the same chunk and split count as the wrappers, from
``split_plan``) against the JAX package's Pallas decode kernels run in
interpret mode and against the port's plain versions.

Inputs come from numpy with a fixed seed and go to both packages, at
``llama_tiny``'s heads (4 q / 2 kv heads of 16).  The lens cover 0, 1, a
chunk exactly, one less and one more, the whole cache, and a slot whose
every split but the first is empty.  The CUDA kernels themselves are
checked against these models by the ``gpu`` tests of test_torch_ops.py,
test_torch_kv_quant.py and test_torch_paged.py and by chip_smoke.py.
"""

import math

import jax  # noqa: F401  (both frameworks in one process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuberay_tpu.models import llama as jllama
from kuberay_tpu.ops.decode_attention import (
    decode_attention_pallas,
    decode_attention_quant_pallas,
)
from kuberay_tpu.ops.paged_attention import paged_decode_attention_pallas
from kuberay_tpu.serve import kv_cache as jkv
from kuberay_tpu_torch.ops import decode_attention as tda
from kuberay_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(2)

CFG = jllama.CONFIGS["llama_tiny"]
HQ, HKV = CFG.n_heads, CFG.n_kv_heads
D = CFG.d_model // CFG.n_heads
C = tda.CHUNK
M = 3 * C                                  # three splits
LENS = [0, 1, C - 1, C, C + 1, M, C // 2]  # the last: splits 2 and 3 empty
# float32: summation order only (the JAX package's own kernel-vs-XLA
# tolerance for the int8 form); bf16: the Pallas kernel rounds the
# probabilities to bf16 before P @ V, the model keeps them float32.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
QUANT_TOL = 2e-4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _dense(seed):
    rng = np.random.default_rng(seed)
    S = len(LENS)
    return (rng.normal(size=(S, HQ, D)).astype(np.float32),
            rng.normal(size=(S, M, HKV, D)).astype(np.float32),
            rng.normal(size=(S, M, HKV, D)).astype(np.float32))


@pytest.mark.parametrize("cap,want", [(1, 1), (C - 1, 1), (C, 1),
                                      (C + 1, 2), (M, 3), (2048, 2048 // C)])
def test_split_plan_is_ceil_of_capacity_over_chunk(cap, want):
    assert tda.split_plan(cap) == want
    assert tda.workspace_numel(8, 32, 128, want) == 8 * 32 * want * 130


@pytest.mark.parametrize("chunk", [0, -tda.TILE, tda.TILE + 1, 100])
def test_split_plan_refuses_a_chunk_off_the_tile(chunk):
    with pytest.raises(ValueError):
        tda.split_plan(M, chunk)


def test_split_count_and_workspace_depend_on_capacity_alone():
    """The same partials' shape for any lens: nothing about lens decides
    how many splits run or how large the workspace is."""
    q, k, v = (_t(a) for a in _dense(1))
    shapes = set()
    for lens in ([0] * len(LENS), LENS, [M] * len(LENS)):
        acc, m, l = tda.split_partials_ref(q, k, v, _t(np.array(
            lens, np.int32)))
        shapes.add((acc.shape, m.shape, l.shape,
                    tda.pack_partials(acc, m, l).numel()))
    nsplit = tda.split_plan(M)
    S = len(LENS)
    assert shapes == {((S, HQ, nsplit, D), (S, HQ, nsplit), (S, HQ, nsplit),
                       tda.workspace_numel(S, HQ, D, nsplit))}


def test_empty_partials_are_marked_and_add_nothing():
    """A split at or past lens[s] has m = -inf, l = 0 and acc 0; the
    merge reads none of its acc (NaN there changes nothing) and a slot
    with every split empty gives exactly 0."""
    q, k, v = (_t(a) for a in _dense(2))
    lens = _t(np.array(LENS, np.int32))
    acc, m, l = tda.split_partials_ref(q, k, v, lens)
    live = torch.arange(tda.split_plan(M))[None, :] * C < lens[:, None]
    assert torch.equal(l[:, :, :] > 0, live[:, None, :].expand_as(l))
    assert torch.isneginf(m[~live[:, None, :].expand_as(m)]).all()
    assert not acc[~live[:, None, :].expand_as(l)].any()
    poisoned = acc.masked_fill(~(l > 0)[..., None], math.nan)
    want = tda.merge_ref(acc, m, l, torch.float32)
    got = tda.merge_ref(poisoned, m, l, torch.float32)
    assert torch.equal(got, want) and torch.isfinite(got).all()
    assert not got[0].any()


def test_pack_partials_layout():
    """acc [S * Hq, nsplit, D], then (m, l) pairs [S * Hq, nsplit, 2]."""
    S, n = 2, 3
    acc = torch.arange(S * HQ * n * D, dtype=torch.float32).reshape(
        S, HQ, n, D)
    m = torch.arange(S * HQ * n, dtype=torch.float32).reshape(S, HQ, n)
    l = -m
    ws = tda.pack_partials(acc, m, l)
    assert ws.numel() == tda.workspace_numel(S, HQ, D, n)
    head = ws[:acc.numel()].reshape(S * HQ, n, D)
    ml = ws[acc.numel():].reshape(S * HQ, n, 2)
    assert torch.equal(head, acc.reshape(S * HQ, n, D))
    assert torch.equal(ml[..., 0], m.reshape(S * HQ, n))
    assert torch.equal(ml[..., 1], l.reshape(S * HQ, n))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_split_ref_matches_pallas_interpret(dtype):
    q, k, v = _dense(3)
    lens = np.array(LENS, np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = decode_attention_pallas(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                   jnp.asarray(v, jd), jnp.asarray(lens),
                                   bkv=C, interpret=True)
    tq, tk, tv = (_t(a).to(td) for a in (q, k, v))
    got = tda.decode_attention_split_ref(tq, tk, tv, _t(lens))
    assert got.dtype == td and got.shape == (len(LENS), HQ, D)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(
        _np(got), _np(tda.decode_attention_ref(tq, tk, tv, _t(lens))),
        rtol=0, atol=TOL[dtype])
    assert not _np(got)[0].any()


def test_quant_split_ref_matches_pallas_interpret():
    """The int8 form: the key scale in the score column, the value scale
    on p after p joins l, as the TPU kernel folds them."""
    q, k, v = _dense(4)
    kq, ks = jkv.quantize_kv(jnp.asarray(k))
    vq, vs = jkv.quantize_kv(jnp.asarray(v))
    ks, vs = (np.asarray(jnp.moveaxis(s[..., 0], -1, 1)) for s in (ks, vs))
    kq, vq = np.asarray(kq), np.asarray(vq)
    lens = np.array(LENS, np.int32)
    want = decode_attention_quant_pallas(q, kq, ks, vq, vs,
                                         jnp.asarray(lens), bkv=C,
                                         interpret=True)
    args = (_t(q), _t(kq), _t(ks), _t(vq), _t(vs), _t(lens))
    got = tda.decode_attention_quant_split_ref(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=QUANT_TOL,
                               atol=QUANT_TOL)
    np.testing.assert_allclose(got.numpy(),
                               tda.decode_attention_quant_ref(*args).numpy(),
                               rtol=0, atol=1e-5)
    assert not got[0].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_split_ref_matches_pallas_interpret(dtype):
    """Through scrambled block tables (block size 16, a page shared by two
    slots) whose capacity is three chunks."""
    bs, S = 16, len(LENS)
    maxb = M // bs
    nblk = S * maxb
    rng = np.random.default_rng(5)
    q = rng.normal(size=(S, HQ, D)).astype(np.float32)
    pk, pv = (rng.normal(size=(HKV, nblk * bs, D)).astype(np.float32)
              for _ in range(2))
    tables = rng.permutation(nblk).reshape(S, maxb).astype(np.int32)
    tables[1, :2] = tables[0, :2]
    lens = np.array(LENS, np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = paged_decode_attention_pallas(
        jnp.asarray(q, jd), jnp.asarray(pk, jd), jnp.asarray(pv, jd),
        jnp.asarray(lens), jnp.asarray(tables), bs, interpret=True)
    tq, tk, tv = (_t(a).to(td) for a in (q, pk, pv))
    got = tpa.paged_decode_attention_split_ref(tq, tk, tv, _t(lens),
                                               _t(tables), bs)
    assert got.dtype == td and got.shape == (S, HQ, D)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(
        _np(got), _np(tpa.paged_decode_attention_ref(tq, tk, tv, _t(lens),
                                                     _t(tables), bs)),
        rtol=0, atol=TOL[dtype])
    assert not _np(got)[0].any()


@pytest.mark.parametrize("chunk", [tda.TILE, 2 * tda.TILE, M])
def test_partials_merge_to_the_plain_result_at_any_chunk(chunk):
    """Any chunk that is a multiple of the tile merges to the plain
    result: the merge's rescale is exact up to float32 rounding."""
    q, k, v = (_t(a) for a in _dense(6))
    lens = _t(np.array(LENS, np.int32))
    got = tda.merge_ref(*tda.split_partials_ref(q, k, v, lens, chunk=chunk),
                        torch.float32)
    np.testing.assert_allclose(
        got.numpy(), tda.decode_attention_ref(q, k, v, lens).numpy(),
        rtol=0, atol=1e-5)
