"""The Hopper flash-backward kernels' tile plan, modelled on the CPU.

``csrc/attn_bwd_sm90.cuh`` walks a plan that only the card runs:

- dK/dV: a block per kv tile of ``BWD_KV_TILE`` keys (two halves of 64,
  one per consumer warpgroup), kv tile 0 (seen by the most q rows) first;
  it steps over q tiles of ``BWD_Q_STEP`` rows of each q head of the
  group, from the first q tile holding a row that sees the block's first
  key to the last q tile;
- dQ: a block per q tile of ``BWD_DQ_Q_TILE`` rows (two halves of 64),
  last tile first, over K/V tiles of ``BWD_DQ_KV_TILE`` keys up to the
  last key the tile's last row sees;
- a half skips a tile that none of its (row, key) pairs sees; only tiles
  that the diagonal or a ragged edge cuts are masked (P and dS set to 0);
  P and dS are rounded to the working dtype before the products.

The model here walks the same plan in plain torch, with the tile sizes
from ``ops/attention.py``, which the .cu mirrors.  A plan that skipped a
tile something sees, or left a cut tile unmasked (TMA's zero fill gives
P = exp(-lse), not 0), moves the gradients far past the tolerances; the
plan itself is also checked pair by pair against brute-force visibility.

The model is held to the port's plain versions (``flash_bwd_dkv_ref``,
``flash_bwd_dq_ref``) and to the JAX package: ``_flash_bwd`` in interpret
mode where 64-row blocks divide the lengths, else ``jax.grad`` through
``attention_xla`` (the JAX package's own path for such lengths).
Tolerances as tests/test_torch_attention.py: float32 1e-5 (summation
order only), bfloat16 2e-2 (P and dS rounded at the same places from f32
values that differ in the last bits), times the reference's largest
magnitude where that is above 1.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuberay_tpu.ops import attention as ja
from kuberay_tpu_torch.ops import attention as ta

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
KV_TILE, Q_STEP = ta.BWD_KV_TILE, ta.BWD_Q_STEP
DQ_Q_TILE, DQ_KV_TILE = ta.BWD_DQ_Q_TILE, ta.BWD_DQ_KV_TILE
HALF = 64          # rows or keys a consumer warpgroup owns


def _visible(Sq, Skv, causal, pad=0):
    """[Sq + pad, Skv + pad] bool: row r sees key k (bottom-right causal
    alignment); the padding, past Sq or Skv, sees nothing."""
    r = np.arange(Sq + pad)[:, None]
    k = np.arange(Skv + pad)[None, :]
    vis = (r < Sq) & (k < Skv)
    return vis & (k <= r + Skv - Sq) if causal else vis


def dkv_plan(Sq, Skv, causal):
    """[(kv0, key0, q0, cut)] in the dK/dV kernel's order for one q head:
    kv tiles in order, halves, q tiles from the block's first; tiles a
    half skips are left out."""
    off, nq = Skv - Sq, -(-Sq // Q_STEP)
    plan = []
    for kv0 in range(0, Skv, KV_TILE):
        row_min = max(kv0 - off, 0) if causal else 0
        first = min(row_min // Q_STEP, nq)
        for i in range(first, nq):
            q0 = i * Q_STEP
            q_last = min(q0 + Q_STEP, Sq) - 1
            for key0 in (kv0, kv0 + HALF):
                if key0 >= Skv or (causal and key0 > q_last + off):
                    continue
                cut = (q0 + Q_STEP > Sq or key0 + HALF > Skv
                       or (causal and key0 + HALF - 1 > q0 + off))
                plan.append((kv0, key0, q0, cut))
    return plan


def dq_plan(Sq, Skv, causal):
    """[(q0, row0, kv0, cut)] in the dQ kernel's order for one q head: q
    tiles last first, halves, K/V tiles up to the last key the tile's last
    row sees; tiles a half skips are left out."""
    off = Skv - Sq
    plan = []
    for q0 in reversed(range(0, Sq, DQ_Q_TILE)):
        last_row = min(q0 + DQ_Q_TILE, Sq) - 1
        end = min(max(last_row + off + 1, 0), Skv) if causal else Skv
        for row0 in (q0, q0 + HALF):
            row_last = min(row0 + HALF - 1, Sq - 1)
            for kv0 in range(0, end, DQ_KV_TILE):
                if row_last < row0 or (causal and kv0 > row_last + off):
                    continue
                cut = kv0 + DQ_KV_TILE > Skv or (
                    causal and kv0 + DQ_KV_TILE - 1 > row0 + off)
                plan.append((q0, row0, kv0, cut))
    return plan


def _tile(x, start, n):
    """Rows [start, start + n) of x, zeros past its end (TMA's fill)."""
    out = x.new_zeros((n,) + tuple(x.shape[1:]))
    part = x[start:start + n]
    out[:part.shape[0]] = part
    return out


def _mask(p, rows, keys, Sq, Skv, causal):
    """p [len(rows), len(keys)] with the pairs no row sees set to 0."""
    r = torch.as_tensor(rows)[:, None]
    k = torch.as_tensor(keys)[None, :]
    vis = (r < Sq) & (k < Skv)
    if causal:
        vis &= k <= r + (Skv - Sq)
    return torch.where(vis, p, torch.zeros_like(p))


def dkv_model(q, k, v, do, lse, delta, causal, scale):
    """dK, dV as the dK/dV kernel's plan computes them."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dk = torch.zeros(B, Skv, Hkv, D)
    dv = torch.zeros(B, Skv, Hkv, D)
    plan = dkv_plan(Sq, Skv, causal)
    for b in range(B):
        for hk in range(Hkv):
            kf, vf = k[b, :, hk].float(), v[b, :, hk].float()
            for g in range(G):
                h = hk * G + g
                for kv0, key0, q0, cut in plan:
                    kt, vt = _tile(kf, key0, HALF), _tile(vf, key0, HALF)
                    qt = _tile(q[b, :, h].float(), q0, Q_STEP)
                    dot = _tile(do[b, :, h].float(), q0, Q_STEP)
                    l = _tile(lse[b, h], q0, Q_STEP)
                    d = _tile(delta[b, h], q0, Q_STEP)
                    st = kt @ qt.T                      # keys x q rows
                    p = torch.exp(st * scale - l[None, :])
                    ds = p * (vt @ dot.T - d[None, :]) * scale
                    if cut:
                        rows = range(q0, q0 + Q_STEP)
                        keys = range(key0, key0 + HALF)
                        p = _mask(p.T, rows, keys, Sq, Skv, causal).T
                        ds = _mask(ds.T, rows, keys, Sq, Skv, causal).T
                    n = min(HALF, Skv - key0)
                    dv[b, key0:key0 + n, hk] += (
                        p.to(do.dtype).float() @ dot)[:n]
                    dk[b, key0:key0 + n, hk] += (
                        ds.to(q.dtype).float() @ qt)[:n]
    return dk.to(k.dtype), dv.to(v.dtype)


def dq_model(q, k, v, do, lse, delta, causal, scale):
    """dQ as the dQ kernel's plan computes it."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dq = torch.zeros(B, Sq, Hq, D)
    plan = dq_plan(Sq, Skv, causal)
    for b in range(B):
        for h in range(Hq):
            kf, vf = k[b, :, h // G].float(), v[b, :, h // G].float()
            for _, row0, kv0, cut in plan:
                qt = _tile(q[b, :, h].float(), row0, HALF)
                dot = _tile(do[b, :, h].float(), row0, HALF)
                l = _tile(lse[b, h], row0, HALF)
                d = _tile(delta[b, h], row0, HALF)
                kt, vt = _tile(kf, kv0, DQ_KV_TILE), _tile(vf, kv0, DQ_KV_TILE)
                p = torch.exp(qt @ kt.T * scale - l[:, None])
                ds = p * (dot @ vt.T - d[:, None]) * scale
                if cut:
                    ds = _mask(ds, range(row0, row0 + HALF),
                               range(kv0, kv0 + DQ_KV_TILE), Sq, Skv, causal)
                n = min(HALF, Sq - row0)
                dq[b, row0:row0 + n, h] += (ds.to(k.dtype).float() @ kt)[:n]
    return dq.to(q.dtype)


# B, Sq, Skv, Hq, Hkv, D, causal
CASES = [
    (1, 40, 40, 2, 1, 64, True),       # shorter than a tile; group 2
    (1, 200, 333, 4, 1, 128, True),    # ragged, Skv > Sq; group 4
    (1, 333, 200, 8, 1, 64, True),     # Sq > Skv: q tile 0 sees no key
    (2, 256, 256, 2, 2, 128, True),    # tiles divide; group 1
    (1, 200, 333, 8, 1, 64, False),    # not causal, ragged; group 8
    (1, 256, 384, 4, 2, 64, False),    # not causal, Skv > Sq; group 2
]
PLAN_LENGTHS = [(1, 1), (40, 40), (64, 64), (127, 129), (200, 333),
                (333, 200), (960, 960), (1000, 1000), (512, 1536),
                (1024, 1024), (130, 70)]


def _inputs(B, Sq, Skv, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in (
        (B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D), (B, Sq, Hq, D))]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, rtol=0,
                               atol=tol * max(1.0, np.abs(w).max()))


def _model_grads(q, k, v, do, out, lse, causal):
    scale = 1.0 / math.sqrt(q.shape[-1])
    delta = ta.attention_delta(out, do)
    dk, dv = dkv_model(q, k, v, do, lse, delta, causal, scale)
    return dq_model(q, k, v, do, lse, delta, causal, scale), dk, dv


@pytest.mark.parametrize("Sq,Skv", PLAN_LENGTHS)
@pytest.mark.parametrize("causal", [True, False])
def test_plan_covers_every_visible_pair_once(Sq, Skv, causal):
    """Both plans, pair by pair: a skipped tile holds no visible pair, an
    uncut tile only visible pairs, and every visible pair lies in exactly
    one planned tile of each plan.  dK/dV sums over q rows, so its uncut
    tiles hold no row past Sq either; dQ never stores rows past Sq, so its
    cut test leaves them out."""
    vis = _visible(Sq, Skv, causal, pad=KV_TILE)
    for plan, tiles, stored in (
            (dkv_plan(Sq, Skv, causal),
             lambda kv0, key0, q0: (q0, Q_STEP, key0, HALF), Sq + KV_TILE),
            (dq_plan(Sq, Skv, causal),
             lambda q0, row0, kv0: (row0, HALF, kv0, DQ_KV_TILE), Sq)):
        cover = np.zeros_like(vis, np.int32)
        for *at, cut in plan:
            r0, nr, k0, nk = tiles(*at)
            tile = vis[r0:r0 + nr, k0:k0 + nk]
            assert tile.any(), "a planned tile that nothing sees"
            assert cut or tile[:stored - r0].all(), \
                "an uncut tile with a hidden pair"
            cover[r0:r0 + nr, k0:k0 + nk] += 1
        assert (cover <= 1).all()
        assert (cover[vis] == 1).all(), "a visible pair the plan skips"
    for kv0, key0, q0, _ in dkv_plan(Sq, Skv, causal):
        assert kv0 % KV_TILE == 0 and key0 in (kv0, kv0 + HALF)


def test_plan_orders_longest_first():
    """dK/dV blocks from kv tile 0 and dQ blocks from the last q tile:
    under a causal mask, the blocks with the most tiles start first."""
    kv_blocks = [kv0 for kv0, *_ in dkv_plan(1000, 1000, True)]
    assert kv_blocks == sorted(kv_blocks)
    q_blocks = [q0 for q0, *_ in dq_plan(1000, 1000, True)]
    assert q_blocks == sorted(q_blocks, reverse=True)
    per_kv = [kv_blocks.count(t) for t in sorted(set(kv_blocks))]
    per_q = [q_blocks.count(t) for t in sorted(set(q_blocks), reverse=True)]
    assert per_kv == sorted(per_kv, reverse=True)
    assert per_q == sorted(per_q, reverse=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal", CASES)
def test_tile_model_matches_plain_versions(dtype, B, Sq, Skv, Hq, Hkv, D,
                                           causal):
    q, k, v, do = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in
                   _inputs(B, Sq, Skv, Hq, Hkv, D, seed=Sq + 7 * Hq + D))
    out, lse = ta.flash_fwd_ref(q, k, v, causal)
    delta = ta.attention_delta(out, do)
    dq, dk, dv = _model_grads(q, k, v, do, out, lse, causal)
    rdk, rdv = ta.flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal)
    rdq = ta.flash_bwd_dq_ref(q, k, v, do, lse, delta, causal)
    for got, want, like in ((dq, rdq, q), (dk, rdk, k), (dv, rdv, v)):
        assert got.dtype == like.dtype and got.shape == like.shape
        _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal", [
    (2, 256, 256, 2, 2, 128, True),    # group 1, D 128
    (1, 256, 384, 4, 2, 64, False),    # not causal, Skv > Sq
    (1, 128, 256, 8, 1, 64, True),     # group 8, offset 128
    (1, 128, 128, 8, 2, 128, True),    # group 4
])
def test_tile_model_matches_pallas_interpret(dtype, B, Sq, Skv, Hq, Hkv, D,
                                             causal):
    """Against the JAX package's _flash_bwd (interpret mode, 64-row
    blocks), both backwards from the JAX forward's (out, lse)."""
    arrs = _inputs(B, Sq, Skv, Hq, Hkv, D, seed=3 * Sq + Hq + D)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(getattr(jnp, dtype))
                       .transpose(0, 2, 1, 3) for a in arrs)
    scale = 1.0 / math.sqrt(D)
    jo, jlse = ja._flash_fwd(jq, jk, jv, scale, causal, 64, 64, True)
    want = ja._flash_bwd(jq, jk, jv, jo, jlse, jdo, scale, causal, 64, 64,
                         True)
    tdt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in arrs)
    out = torch.from_numpy(_np(jo).transpose(0, 2, 1, 3).copy()).to(tdt)
    lse = torch.from_numpy(_np(jlse)[..., 0].copy())
    got = _model_grads(q, k, v, do, out, lse, causal)
    for g, w in zip(got, want):
        _close(g, w.transpose(0, 2, 1, 3), TOL[dtype])


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal", [
    (1, 40, 40, 2, 1, 64, True),
    (1, 200, 333, 4, 1, 128, True),
    (1, 200, 333, 8, 1, 64, False),
])
def test_tile_model_matches_jax_grad_on_ragged_lengths(B, Sq, Skv, Hq, Hkv,
                                                       D, causal):
    """Lengths no block divides (the JAX package runs attention_xla
    there): the model's gradients against jax.grad in float32."""
    q, k, v, do = _inputs(B, Sq, Skv, Hq, Hkv, D, seed=Skv + D)

    def loss(q_, k_, v_):
        return jnp.sum(ja.attention_xla(q_, k_, v_, causal) * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in (q, k, v)))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = ta.flash_fwd_ref(tq, tk, tv, causal)
    got = _model_grads(tq, tk, tv, tdo, out, lse, causal)
    for g, w in zip(got, want):
        _close(g, w, TOL["float32"])
