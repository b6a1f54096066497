"""KV-cache inference path for the Llama family, in PyTorch.

Port of ``kuberay_tpu/serve/kv_cache.py``: the dense cache
``[layers, slots, max_len, kv_heads, head_dim]`` in bf16, or in int8 with
one float32 absmax scale per (slot, head, position) vector, and per-slot
lengths that drive masking.  Where the JAX version returns a new cache,
this one writes the new K/V into the cache tensors in place (and returns
them), so a step holds one copy of the cache, not two.

``forward_with_cache`` keeps the JAX package's seams: ``kv_update``
chooses the cache layout (dense here; the int8 cache below; the paged pool
in ``serve/paged_kv.py``), ``attention`` how attention reads it, and
``ffn`` the feed-forward block (dense SwiGLU by default; the dropless MoE
of ``forward_with_cache_mixtral`` for Mixtral configs, which
``base_forward_for`` picks by config type for both engines).

Under a serving ``layout`` (``serve/sharding.py``) the forward runs on this
rank's shards: head counts come from the shards' shapes, the embedding is
a vocab-parallel lookup, ``wo``'s and the FFN's outputs are summed over
``(tp, tpr)`` (one all-reduce each a layer) and the logits are gathered
over ``(tp, tpr)``.  Every rank of the group issues the same collectives
in the same order; the cache holds the rank's kv heads only.

Per step the model reaches two kernels: ``ops/rmsnorm.py`` (2 per layer +
the final norm) and one attention kernel a layer.  ``attention_route``
picks it from the call's shape and the cache's element type, for every
cache forward.  One-token steps ("decode") take a decode-attention kernel:
``decode_attention`` for the bf16 cache, ``decode_attention_quant`` for
the int8 cache, ``paged_decode_attention`` for the paged pool.  One row
of more than one token over a bf16 cache ("live": a prefill, a prefill
chunk, a one-slot verify) takes the flash forward kernel over the row's
live columns (``_live_attention``).  The other multi-token calls
("masked": rows at different offsets, the int8 cache) are plain torch
over the whole cache, as they are plain XLA in the reference.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from kuberay_tpu_torch.models.mixtral import MixtralConfig, moe_ffn_dropless
from kuberay_tpu_torch.ops.attention import flash_fwd
from kuberay_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_quant,
)
from kuberay_tpu_torch.ops.rmsnorm import rmsnorm
from kuberay_tpu_torch.ops.rope import apply_rope, rope_frequencies
from kuberay_tpu_torch.parallel.spmd import embed_lookup, reduce_over
from kuberay_tpu_torch.serve.sharding import SERVE_AXES

_NEG_INF = -1e30


def init_kv_cache(cfg, slots: int, max_len: int, device="cuda",
                  quant: str = "none", n_kv_heads: Optional[int] = None
                  ) -> Dict[str, Any]:
    """Zeroed dense cache {"k", "v"}, each [L, slots, max_len, Hkv, D] in
    ``cfg.dtype``; with ``quant="int8"`` each is {"q": int8 [L, slots,
    max_len, Hkv, D], "s": float32 [L, slots, Hkv, max_len]} (scales with
    positions on the last axis, the layout the int8 decode kernel reads).
    ``n_kv_heads``: Hkv where not the model's (a tp rank's local heads)."""
    hkv = n_kv_heads or cfg.n_kv_heads
    shape = (cfg.n_layers, slots, max_len, hkv, cfg.head_dim)
    if quant == "int8":
        sshape = (cfg.n_layers, slots, hkv, max_len)

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


def attention_route(B: int, T: int, cache) -> str:
    """The attention of a forward of B rows of T new tokens against
    ``cache`` (its leaves' element type decides): "decode" for one token a
    row (a decode kernel); "live" for one row of more than one token over
    a bf16 cache (``_live_attention`` over the row's cached prefix and new
    K/V); "masked" otherwise (rows at different offsets, as a verify step
    over every slot, and the int8 cache: the masked attention over the
    whole cache)."""
    if T == 1:
        return "decode"
    k = cache["k"]
    if B == 1 and isinstance(k, torch.Tensor) and k.dtype == torch.bfloat16:
        return "live"
    return "masked"


def _decode_attention(q, ck, cv, lens, q_positions):
    """One-token attention over the bf16 cache, through its kernel."""
    return decode_attention(q[:, 0].contiguous(), ck, cv,
                            lens.to(torch.int32))[:, None]


def _cached_attention(q, ck, cv, lens, q_positions):
    """q: [B, T, Hq, D] new queries; ck/cv: [B, M, Hkv, D] cache (already
    holding the new tokens); lens: [B] valid lengths after insertion;
    q_positions: [B, T] absolute query positions."""
    B, T, Hq, D = q.shape
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


def live_columns(prefix: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """[1, start + T, Hkv, D]: the row's cached prefix (its first
    ``start`` columns, [1, start, Hkv, D]) then the new K or V (after
    RoPE); at ``start`` 0 the new K or V itself, with no copy."""
    return new if prefix.shape[1] == 0 else torch.cat([prefix, new], 1)


def _live_attention(q, k_live, v_live, lens, q_positions):
    """One row's T > 1 new queries (q [1, T, Hq, D], contiguous) over its
    live columns (``live_columns``) through the flash forward kernel, the
    lse discarded.  The kernel's bottom-right causal alignment gives query
    row r (position start + r) exactly the keys <= start + r, the columns
    ``_cached_attention``'s mask keeps; bucket padding rows lie after
    every real row, so no real row sees them.  CPU tensors take
    ``flash_fwd_ref``."""
    return flash_fwd(q, k_live, v_live, causal=True)[0]


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


def make_quantized_forward(base_forward=None, layout=None):
    """Wrap a cache forward for the int8 cache (``init_kv_cache(...,
    quant="int8")``): its ``kv_update`` quantises the new K/V and writes
    values and scales in place; its ``attention`` reads the int8 cache
    natively, through the int8 decode kernel on the "decode" route and
    ``_cached_attention_quant_multi`` on the others (the int8 cache never
    routes "live", ``attention_route``).  The returned forward
    takes ``forward_with_cache``'s arguments; ``layout``: a tp rank's
    serving layout, passed to the base forward."""
    base = base_forward or forward_with_cache

    def fwd(cfg, params, tokens, cache, start, write_mask=None,
            token_mask=None, logits_index=None):
        B, T = tokens.shape
        dev = tokens.device
        route = attention_route(B, T, cache)
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

        attention = _decode_attention_quant if route == "decode" \
            else _cached_attention_quant_multi
        return base(cfg, params, tokens, cache, start, write_mask,
                    token_mask=token_mask, logits_index=logits_index,
                    kv_update=kv_update, attention=attention, layout=layout)

    return fwd


def _dense_ffn(cfg, h, lp, token_mask):
    return (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]


def _moe_ffn(cfg, h, lp, token_mask):
    # Dropless routing for decode and prefill alike: a token's experts
    # depend on its own hidden state only, so outputs do not depend on
    # batch composition, chunk boundaries or cached-prefix reuse (capacity
    # routing, the training path, has none of these properties).
    return moe_ffn_dropless(cfg, h, lp, token_mask=token_mask)


def forward_with_cache_mixtral(cfg, params, tokens, cache, start,
                               write_mask=None, logits_index=None,
                               token_mask=None, kv_update=None,
                               attention=None, layout=None):
    """Mixtral against the cache: ``forward_with_cache`` with the dropless
    MoE FFN.  The token mask keeps padding and idle slots' weight out of
    the expert combine; router aux losses play no part at inference.
    Under a layout every rank holds every expert's block of mlp columns
    (``SERVE_RULES``: expert replicated, mlp over (tp, tpr)) and the
    replicated router, so each rank routes every token alike and the
    grouped ``w_down``'s partial sums meet in the forward's all-reduce."""
    return forward_with_cache(cfg, params, tokens, cache, start, write_mask,
                              logits_index=logits_index,
                              token_mask=token_mask, kv_update=kv_update,
                              attention=attention, ffn=_moe_ffn,
                              layout=layout)


def base_forward_for(cfg):
    """The cache forward of a config's model family: None (the default,
    ``forward_with_cache``) for Llama, ``forward_with_cache_mixtral`` for
    a ``MixtralConfig``."""
    return forward_with_cache_mixtral if isinstance(cfg, MixtralConfig) \
        else None


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
                       kv_update=None, attention=None, ffn=None,
                       layout=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
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
    reads.  Where neither is given, ``attention_route`` picks them: the
    dense cache's insert, then on "decode" ``_decode_attention`` over the
    cache, on "live" ``_live_attention`` over the row's first ``start``
    cached columns and the new K/V, on "masked" ``_cached_attention`` over
    the cache.  An explicit one overrides the route: the other is then
    the insert handing over the whole cache, or ``_cached_attention``
    (multi-token calls).  ``ffn(cfg, h, lp, token_mask)`` is the
    feed-forward block (default: the dense SwiGLU).  ``layout``: this
    rank's serving layout (``serve/sharding.py``), with ``params`` and
    ``cache`` its shards; None for one process.  Returns (float32 logits
    [B, T or 1, V], the cache, updated in place).
    """
    B, T = tokens.shape
    dev = tokens.device
    route = attention_route(B, T, cache) \
        if kv_update is None and attention is None else "masked"
    # The live prefix's length, read before ``start`` goes to the device:
    # no sync where the caller keeps it on the host, as the engines do.
    s0 = int(start[0]) if route == "live" else 0
    start = start.to(device=dev, dtype=torch.long)
    positions = start[:, None] + torch.arange(T, device=dev)[None, :]
    lens = (start + T).to(torch.int32)
    if write_mask is None:
        write_mask = torch.ones(B, device=dev)
    if attention is None:
        attention = _decode_attention if route == "decode" else \
            _live_attention if route == "live" else _cached_attention
    if ffn is None:
        ffn = _dense_ffn
    if kv_update is None:
        def kv_update(ck, cv, kk, vv):
            _insert_kv(ck, cv, kk, vv, positions, start, write_mask, T,
                       token_mask)
            if route != "live":
                return ck, cv
            return (live_columns(ck[:, :s0], kk),
                    live_columns(cv[:, :s0], vv))
    cos, sin = _rope_tables(cfg.head_dim, cfg.max_seq_len,
                            float(cfg.rope_theta), torch.device(dev))
    # Bucket padding past a cached prefix may run past the tables; those
    # positions are never written or read back (JAX's gather clamps too).
    rope_pos = positions.clamp(max=cfg.max_seq_len - 1)
    hd = cfg.head_dim
    layers = params["layers"]
    x = embed_lookup(params["embed"], tokens, layout, *SERVE_AXES)
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        ck, cv = (tree_map(lambda t: t[i], cache[n]) for n in ("k", "v"))
        # Local head counts: a tp rank's shards hold its heads only.
        hq, hkv = lp["wq"].shape[-1] // hd, lp["wk"].shape[-1] // hd
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q = (h @ lp["wq"]).reshape(B, T, hq, hd)
        kk = (h @ lp["wk"]).reshape(B, T, hkv, hd)
        vv = (h @ lp["wv"]).reshape(B, T, hkv, hd)
        q = apply_rope(q, cos, sin, rope_pos)
        kk = apply_rope(kk, cos, sin, rope_pos)
        k_view, v_view = kv_update(ck, cv, kk, vv)
        attn = attention(q, k_view, v_view, lens, positions)
        x = x + reduce_over(attn.reshape(B, T, -1) @ lp["wo"], layout,
                            *SERVE_AXES).to(x.dtype)
        h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + reduce_over(ffn(cfg, h, lp, token_mask), layout,
                            *SERVE_AXES).to(x.dtype)
        # Drop the layer's leaves before the next layer's are made: with
        # int8 weights each is a dequantised copy, so only one layer's
        # bf16 weights are held at a time.
        del lp
    if logits_index is not None:
        rows = torch.arange(B, device=dev)
        x = x[rows, logits_index.to(device=dev, dtype=torch.long)][:, None]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if getattr(cfg, "tie_embeddings", False) \
        else params["lm_head"]
    logits = _logits(x, head)
    if layout is not None:
        # This rank's vocabulary block -> the whole row, innermost axis
        # first, so the blocks land in (tp, tpr) order.
        for a in reversed(SERVE_AXES):
            logits = layout.all_gather(logits, a, logits.dim() - 1)
    return logits, cache
