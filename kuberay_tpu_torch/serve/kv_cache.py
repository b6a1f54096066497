"""KV-cache inference path for the Llama family, in PyTorch.

Port of ``kuberay_tpu/serve/kv_cache.py``: the dense cache
``[layers, slots, max_len, kv_heads, head_dim]`` in bf16, or in int8 with
one float32 absmax scale per (slot, head, position) vector, and per-slot
lengths that drive masking.  Where the JAX version returns a new cache,
this one writes the new K/V into the cache tensors in place (and returns
them), so a step holds one copy of the cache, not two.

``forward_with_cache`` keeps the JAX package's seams: ``kv_update``
chooses the cache layout (dense here; the int8 cache below; the paged pool
in ``serve/paged_kv.py``) and ``attention`` how attention reads it.

Per step the model reaches two kernels: ``ops/rmsnorm.py`` (2 per layer +
the final norm) and, for one-token steps, a decode-attention kernel (one
per layer): ``decode_attention`` for the bf16 cache,
``decode_attention_quant`` for the int8 cache, ``paged_decode_attention``
for the paged pool.  Multi-token (prefill) attention is plain torch, as it
is plain XLA in the reference.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from kuberay_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_quant,
)
from kuberay_tpu_torch.ops.rmsnorm import rmsnorm
from kuberay_tpu_torch.ops.rope import apply_rope, rope_frequencies

_NEG_INF = -1e30


def init_kv_cache(cfg, slots: int, max_len: int, device="cuda",
                  quant: str = "none") -> Dict[str, Any]:
    """Zeroed dense cache {"k", "v"}, each [L, slots, max_len, Hkv, D] in
    ``cfg.dtype``; with ``quant="int8"`` each is {"q": int8 [L, slots,
    max_len, Hkv, D], "s": float32 [L, slots, Hkv, max_len]} (scales with
    positions on the last axis, the layout the int8 decode kernel reads)."""
    shape = (cfg.n_layers, slots, max_len, cfg.n_kv_heads, cfg.head_dim)
    if quant == "int8":
        sshape = (cfg.n_layers, slots, cfg.n_kv_heads, max_len)

        def leaf():
            return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                    "s": torch.zeros(sshape, dtype=torch.float32,
                                     device=device)}
        return {"k": leaf(), "v": leaf()}
    if quant != "none":
        raise ValueError(f"unknown kv quant {quant!r}")
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor of a nested dict (a cache)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8: scale = absmax / 127 over the head dim,
    floored at 1e-8.  x: [..., D] -> (q int8 [..., D], s float32 [..., 1]).
    ``torch.round`` rounds half to even, as ``jnp.round``."""
    xf = x.float()
    s = (xf.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * s).to(dtype)


@functools.lru_cache(maxsize=8)
def _rope_tables(head_dim: int, max_len: int, theta: float,
                 device: torch.device):
    return rope_frequencies(head_dim, max_len, theta, device=device)


def _write_sel(write_mask, token_mask, positions, M):
    """[B, T] bool: the (row, token) pairs a multi-token call writes:
    in-range positions of writable rows, and of real tokens where a token
    mask is given."""
    sel = (positions < M) & (write_mask[:, None] > 0)
    if token_mask is not None:
        sel &= token_mask > 0
    return sel


def _insert(c, new, positions, start, write_mask, T, token_mask=None):
    """Write new rows into one cache tensor in place.  c: [B, M, ...] (one
    layer: K or V [B, M, Hkv, D], or a scale tensor's [B, M, Hkv]
    transpose view); new: [B, T, ...]; rows whose ``write_mask`` is 0 (and
    tokens whose ``token_mask`` is 0) keep their cache.  One-token steps
    write without a host sync; multi-token steps write every in-range
    position (positions past the cache are dropped, as the reference's
    one-hot insert drops them)."""
    B, M = c.shape[0], c.shape[1]
    if T == 1:
        rows = torch.arange(B, device=c.device)
        pos = start.long().clamp(0, M - 1)
        keep = write_mask <= 0
        if token_mask is not None:
            keep |= token_mask[:, 0] <= 0
        keep = keep.view(B, *[1] * (c.dim() - 2))
        c[rows, pos] = torch.where(keep, c[rows, pos], new[:, 0].to(c.dtype))
        return
    sel = _write_sel(write_mask, token_mask, positions, M)
    rows = torch.arange(B, device=c.device)[:, None].expand(B, T)
    c[rows[sel], positions[sel]] = new[sel].to(c.dtype)


def _insert_kv(ck, cv, kk, vv, positions, start, write_mask, T,
               token_mask=None):
    """Write the new K/V rows (kk/vv [B, T, Hkv, D]) into ck/cv [B, M,
    Hkv, D] in place, as ``_insert``."""
    _insert(ck, kk, positions, start, write_mask, T, token_mask)
    _insert(cv, vv, positions, start, write_mask, T, token_mask)


def _cached_attention(q, ck, cv, lens, q_positions):
    """q: [B, T, Hq, D] new queries; ck/cv: [B, M, Hkv, D] cache (already
    holding the new tokens); lens: [B] valid lengths after insertion;
    q_positions: [B, T] absolute query positions."""
    B, T, Hq, D = q.shape
    if T == 1:
        return decode_attention(q[:, 0].contiguous(), ck, cv,
                                lens.to(torch.int32))[:, None]
    M, Hkv = ck.shape[1], ck.shape[2]
    G = Hq // Hkv
    # float32 scores from the working-dtype operands, as the reference's
    # preferred_element_type=f32 einsum; GQA by grouping, not repeating.
    qg = q.float().reshape(B, T, Hkv, G, D)
    s = torch.einsum("btngd,bmnd->bngtm", qg, ck.float()) / math.sqrt(D)
    cols = torch.arange(M, device=q.device)[None, None, :]
    mask = (cols <= q_positions[:, :, None]) & \
        (cols < lens[:, None, None])                             # [B, T, M]
    s = s.masked_fill(~mask[:, None, None], _NEG_INF)
    p = torch.softmax(s, dim=-1).to(cv.dtype)
    out = torch.einsum("bngtm,bmnd->btngd", p.float(), cv.float())
    return out.reshape(B, T, Hq, D).to(q.dtype)


def _cached_attention_quant_multi(q, ckv, cvv, lens, q_positions):
    """T > 1 attention straight off the int8 cache (the prefill path):
    the key scales fold into the score columns and the value scales into
    the probability rows, so no dequantised copy of the cache is built.
    ckv/cvv: {"q": [B, M, Hkv, D] int8, "s": [B, Hkv, M] float32}."""
    B, T, Hq, D = q.shape
    kq, ks = ckv["q"], ckv["s"]
    vq, vs = cvv["q"], cvv["s"]
    M, Hkv = kq.shape[1], kq.shape[2]
    G = Hq // Hkv
    qg = q.float().reshape(B, T, Hkv, G, D)
    s = torch.einsum("btngd,bmnd->bntgm", qg, kq.float())
    s = s * ks[:, :, None, None, :] / math.sqrt(D)
    cols = torch.arange(M, device=q.device)[None, None, :]
    mask = (cols <= q_positions[:, :, None]) & \
        (cols < lens[:, None, None])                             # [B, T, M]
    s = s.masked_fill(~mask[:, None, :, None, :], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bntgm,bmnd->btngd", p * vs[:, :, None, None, :],
                       vq.float())
    return out.reshape(B, T, Hq, D).to(q.dtype)


def _decode_attention_quant(q, ckv, cvv, lens, q_positions):
    """One-token attention over the int8 cache, through the int8 kernel."""
    return decode_attention_quant(
        q[:, 0].contiguous(), ckv["q"], ckv["s"], cvv["q"], cvv["s"],
        lens.to(torch.int32))[:, None]


def make_quantized_forward(base_forward=None):
    """Wrap a cache forward for the int8 cache (``init_kv_cache(...,
    quant="int8")``): its ``kv_update`` quantises the new K/V and writes
    values and scales in place; its ``attention`` reads the int8 cache
    natively, through the int8 decode kernel for one-token steps and
    ``_cached_attention_quant_multi`` for prefill.  The returned forward
    takes ``forward_with_cache``'s arguments."""
    base = base_forward or forward_with_cache

    def fwd(cfg, params, tokens, cache, start, write_mask=None,
            token_mask=None, logits_index=None):
        B, T = tokens.shape
        dev = tokens.device
        start = start.to(device=dev, dtype=torch.long)
        positions = start[:, None] + torch.arange(T, device=dev)[None, :]
        if write_mask is None:
            write_mask = torch.ones(B, device=dev)

        def kv_update(ck, cv, kk, vv):        # ck/cv: {"q", "s"} per layer
            kq, ks = quantize_kv(kk)          # ks: [B, T, Hkv, 1]
            vq, vs = quantize_kv(vv)
            # Scales [B, Hkv, M] are written through their [B, M, Hkv]
            # transpose views.
            for c, new in ((ck["q"], kq), (cv["q"], vq),
                           (ck["s"].transpose(1, 2), ks[..., 0]),
                           (cv["s"].transpose(1, 2), vs[..., 0])):
                _insert(c, new, positions, start, write_mask, T, token_mask)
            return ck, cv

        attention = _decode_attention_quant if T == 1 \
            else _cached_attention_quant_multi
        return base(cfg, params, tokens, cache, start, write_mask,
                    token_mask=token_mask, logits_index=logits_index,
                    kv_update=kv_update, attention=attention)

    return fwd


def _dense_ffn(h, lp):
    return (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]


def _logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """float32 logits from working-dtype operands.  On CUDA a bf16 product
    writes float32 output directly, so the head is never upcast; the CPU
    computes in float32."""
    if x.device.type == "cuda" and x.dtype != torch.float32:
        out = torch.mm(x.reshape(-1, x.shape[-1]), head,
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], head.shape[-1])
    return x.float() @ head.float()


def forward_with_cache(cfg, params: Dict[str, Any], tokens: torch.Tensor,
                       cache: Dict[str, Any], start: torch.Tensor,
                       write_mask: Optional[torch.Tensor] = None,
                       logits_index: Optional[torch.Tensor] = None,
                       token_mask: Optional[torch.Tensor] = None,
                       kv_update=None, attention=None
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run T new tokens through the model against the cache.

    params: the model's tree, or a ``serve/weight_quant.py::DequantView``
    of an int8 one (the loop's ``v[i]`` then dequantises one layer, and
    ``lm_head`` is dequantised where the logits read it).
    tokens: [B, T] (right-padded); start: [B] tokens already in each row's
    cache; write_mask: [B] 1.0 for rows whose cache may be written;
    token_mask: [B, T] 1.0 for real tokens (the default layout then skips
    padding positions too; the paged layout requires it).
    cache: {"k", "v"}, each [L, B, M, Hkv, D] or a nested dict of such
    leaves (a slot-range view of the engine's cache works: writes land in
    the viewed slots).  The leaves' first axis is the layer.
    logits_index: optional [B] position of each row whose logits are
    wanted; then only those are computed and logits are [B, 1, V] (the
    serving prefill needs one row of a bucket-long prompt).
    ``kv_update(ck, cv, kk, vv) -> (k_view, v_view)`` writes one layer's
    new K/V (kk/vv [B, T, Hkv, D]) into that layer's cache ck/cv in place
    and returns what ``attention(q, k_view, v_view, lens, positions)``
    reads; the defaults are the dense cache's insert and
    ``_cached_attention``.  Returns (float32 logits [B, T or 1, V], the
    cache, updated in place).
    """
    B, T = tokens.shape
    dev = tokens.device
    start = start.to(device=dev, dtype=torch.long)
    positions = start[:, None] + torch.arange(T, device=dev)[None, :]
    lens = (start + T).to(torch.int32)
    if write_mask is None:
        write_mask = torch.ones(B, device=dev)
    if attention is None:
        attention = _cached_attention
    if kv_update is None:
        def kv_update(ck, cv, kk, vv):
            _insert_kv(ck, cv, kk, vv, positions, start, write_mask, T,
                       token_mask)
            return ck, cv
    cos, sin = _rope_tables(cfg.head_dim, cfg.max_seq_len,
                            float(cfg.rope_theta), torch.device(dev))
    # Bucket padding past a cached prefix may run past the tables; those
    # positions are never written or read back (JAX's gather clamps too).
    rope_pos = positions.clamp(max=cfg.max_seq_len - 1)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layers = params["layers"]
    x = params["embed"][tokens]
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        ck, cv = (tree_map(lambda t: t[i], cache[n]) for n in ("k", "v"))
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q = (h @ lp["wq"]).reshape(B, T, hq, hd)
        kk = (h @ lp["wk"]).reshape(B, T, hkv, hd)
        vv = (h @ lp["wv"]).reshape(B, T, hkv, hd)
        q = apply_rope(q, cos, sin, rope_pos)
        kk = apply_rope(kk, cos, sin, rope_pos)
        k_view, v_view = kv_update(ck, cv, kk, vv)
        attn = attention(q, k_view, v_view, lens, positions)
        x = x + (attn.reshape(B, T, -1) @ lp["wo"]).to(x.dtype)
        h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _dense_ffn(h, lp).to(x.dtype)
    if logits_index is not None:
        rows = torch.arange(B, device=dev)
        x = x[rows, logits_index.to(device=dev, dtype=torch.long)][:, None]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return _logits(x, head), cache
