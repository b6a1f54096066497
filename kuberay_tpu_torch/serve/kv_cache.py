"""KV-cache inference path for the Llama family, in PyTorch.

Port of ``kuberay_tpu/serve/kv_cache.py`` (dense bf16 cache).  The cache is
``[layers, slots, max_len, kv_heads, head_dim]`` and per-slot lengths drive
masking.  Where the JAX version returns a new cache, this one writes the
new K/V into the cache tensors in place (and returns them), so a step
holds one copy of the cache, not two.

Per step the model reaches two kernels: ``ops/rmsnorm.py`` (2 per layer +
the final norm) and, for one-token steps, ``ops/decode_attention.py`` (one
per layer).  Multi-token (prefill) attention is plain torch, as it is
plain XLA in the reference.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from kuberay_tpu_torch.ops.decode_attention import decode_attention
from kuberay_tpu_torch.ops.rmsnorm import rmsnorm
from kuberay_tpu_torch.ops.rope import apply_rope, rope_frequencies

_NEG_INF = -1e30


def init_kv_cache(cfg, slots: int, max_len: int,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Zeroed dense cache {"k", "v"}, each [L, slots, max_len, Hkv, D] in
    ``cfg.dtype``."""
    shape = (cfg.n_layers, slots, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


@functools.lru_cache(maxsize=8)
def _rope_tables(head_dim: int, max_len: int, theta: float,
                 device: torch.device):
    return rope_frequencies(head_dim, max_len, theta, device=device)


def _insert_kv(ck, cv, kk, vv, positions, start, write_mask, T):
    """Write the new K/V rows in place.  ck/cv: [B, M, Hkv, D] (one layer);
    kk/vv: [B, T, Hkv, D]; rows whose ``write_mask`` is 0 keep their cache.
    One-token steps write without a host sync; multi-token steps write
    every in-range position (positions past the cache are dropped, as the
    reference's one-hot insert drops them)."""
    B, M = ck.shape[0], ck.shape[1]
    if T == 1:
        rows = torch.arange(B, device=ck.device)
        pos = start.long().clamp(0, M - 1)
        keep = (write_mask <= 0)[:, None, None]
        ck[rows, pos] = torch.where(keep, ck[rows, pos], kk[:, 0].to(ck.dtype))
        cv[rows, pos] = torch.where(keep, cv[rows, pos], vv[:, 0].to(cv.dtype))
        return
    sel = (positions < M) & (write_mask[:, None] > 0)          # [B, T]
    rows = torch.arange(B, device=ck.device)[:, None].expand(B, T)
    ck[rows[sel], positions[sel]] = kk[sel].to(ck.dtype)
    cv[rows[sel], positions[sel]] = vv[sel].to(cv.dtype)


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
                       cache: Dict[str, torch.Tensor], start: torch.Tensor,
                       write_mask: Optional[torch.Tensor] = None,
                       logits_index: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run T new tokens through the model against the cache.

    tokens: [B, T] (right-padded); start: [B] tokens already in each row's
    cache; write_mask: [B] 1.0 for rows whose cache may be written;
    cache: {"k", "v"} of [L, B, M, Hkv, D] (a slot-range view of the
    engine's cache works: writes land in the viewed slots).
    logits_index: optional [B] position of each row whose logits are
    wanted; then only those are computed and logits are [B, 1, V] (the
    serving prefill needs one row of a bucket-long prompt).  Returns
    (float32 logits [B, T or 1, V], the cache, updated in place).
    """
    B, T = tokens.shape
    dev = tokens.device
    start = start.to(device=dev, dtype=torch.long)
    positions = start[:, None] + torch.arange(T, device=dev)[None, :]
    lens = (start + T).to(torch.int32)
    if write_mask is None:
        write_mask = torch.ones(B, device=dev)
    cos, sin = _rope_tables(cfg.head_dim, cfg.max_seq_len,
                            float(cfg.rope_theta), torch.device(dev))
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layers = params["layers"]
    x = params["embed"][tokens]
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        ck, cv = cache["k"][i], cache["v"][i]
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q = (h @ lp["wq"]).reshape(B, T, hq, hd)
        kk = (h @ lp["wk"]).reshape(B, T, hkv, hd)
        vv = (h @ lp["wv"]).reshape(B, T, hkv, hd)
        q = apply_rope(q, cos, sin, positions)
        kk = apply_rope(kk, cos, sin, positions)
        _insert_kv(ck, cv, kk, vv, positions, start, write_mask, T)
        attn = _cached_attention(q, ck, cv, lens, positions)
        x = x + (attn.reshape(B, T, -1) @ lp["wo"]).to(x.dtype)
        h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _dense_ffn(h, lp).to(x.dtype)
    if logits_index is not None:
        rows = torch.arange(B, device=dev)
        x = x[rows, logits_index.to(device=dev, dtype=torch.long)][:, None]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return _logits(x, head), cache
