"""Llama-3-family configuration and parameters, in PyTorch.

Port of ``kuberay_tpu/models/llama.py``: the same ``LlamaConfig`` fields
(``dtype`` is a torch dtype), the same ``CONFIGS`` keys and widths, and the
same parameter tree, a plain dict whose layer leaves are stacked on a
leading ``[n_layers]`` axis, with matmul weights stored ``[in, out]`` so
``x @ w`` reads as in the reference.  The serving path runs the model
through ``serve/kv_cache.py::forward_with_cache``; training runs
``forward_hidden`` / ``forward`` / ``loss_fn`` below.

Training forward: the JAX package ``lax.scan``s one layer body over the
stacked leaves under ``jax.checkpoint``.  Here each forward slices the
stacked leaves once with ``torch.unbind`` (whose backward stacks the layer
gradients once; indexing ``leaf[i]`` would write a full-size zero
gradient per layer) and loops over the layers, each under
``torch.utils.checkpoint`` when ``cfg.remat``: ``"full"`` recomputes the
whole layer in the backward, ``"dots"`` saves the matmul outputs and
recomputes the rest (JAX's ``dots_with_no_batch_dims_saveable``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from kuberay_tpu_torch.ops.attention import attention_ref, flash_attention
from kuberay_tpu_torch.ops.rmsnorm import rmsnorm
from kuberay_tpu_torch.ops.rope import apply_rope, rope_frequencies
from kuberay_tpu_torch.ops.xent import chunked_softmax_xent_loss, logits_f32
from kuberay_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    # Training-side fields (the serving path does not read them).
    # attn_impl: "auto"/"pallas" = the flash kernels (their plain versions
    # on CPU tensors); "xla" = attention_ref, the plain attention the JAX
    # package's "xla" names; "ring"/"ring_rdma" are not ported yet.
    attn_impl: str = "auto"
    remat: bool = True
    remat_policy: str = "full"
    xent_chunk: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def num_params(self) -> int:
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        mlp = 3 * d * f
        per_layer = attn + mlp + 2 * d
        head = 0 if self.tie_embeddings else d * v
        return v * d + L * per_layer + d + head


CONFIGS: Dict[str, LlamaConfig] = {
    "llama_tiny": LlamaConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, dtype=torch.float32, attn_impl="xla",
        remat=False),
    "llama_125m": LlamaConfig(
        vocab_size=32000, d_model=768, n_layers=12, n_heads=12, n_kv_heads=12,
        d_ff=2048, max_seq_len=2048),
    "llama_1b": LlamaConfig(
        vocab_size=32768, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=8,
        d_ff=8192, max_seq_len=4096),
    # Llama-3-8B's published widths.
    "llama3_8b": LlamaConfig(xent_chunk=16384),
    "llama3_70b": LlamaConfig(
        d_model=8192, n_layers=80, n_heads=64, n_kv_heads=8, d_ff=28672,
        xent_chunk=16384),
}


def init_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict[str, Any]:
    """Scaled-normal init (GPT-NeoX style residual scaling on out-projs),
    the reference's tree and scales.  Draws float32 normals from
    ``generator`` (which must live on ``device``; default: seed 0 there)
    and casts each leaf to ``cfg.dtype``.  ``device="meta"`` builds shapes
    only.  torch's generator draws other numbers than ``jax.random``: to
    hold the two packages to one tree, convert the JAX tree with
    ``models/convert.py``."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    std = 1.0 / math.sqrt(d)
    out_std = std / math.sqrt(2 * L)

    def norm_init(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    def rnd(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return w.mul_(scale).to(cfg.dtype)

    params = {
        "embed": rnd((v, d), std),
        "layers": {
            "attn_norm": norm_init(L, d),
            "wq": rnd((L, d, hq * hd), std),
            "wk": rnd((L, d, hkv * hd), std),
            "wv": rnd((L, d, hkv * hd), std),
            "wo": rnd((L, hq * hd, d), out_std),
            "mlp_norm": norm_init(L, d),
            "w_gate": rnd((L, d, f), std),
            "w_up": rnd((L, d, f), std),
            "w_down": rnd((L, f, d), out_std),
        },
        "final_norm": norm_init(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = rnd((d, v), std)
    return params


# --------------------------------------------------------------------------
# Training forward and loss
# --------------------------------------------------------------------------

def _attention(cfg: LlamaConfig, q, k, v):
    if cfg.attn_impl in ("ring", "ring_rdma"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r}: sequence-parallel ring attention "
            f"is not ported yet (ROADMAP C6)")
    if cfg.attn_impl == "xla":
        return attention_ref(q, k, v, causal=True)
    if cfg.attn_impl in ("auto", "pallas", "pallas_interpret"):
        return flash_attention(q, k, v, causal=True)
    raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


def _layer(cfg: LlamaConfig, x: torch.Tensor, lp: Dict[str, torch.Tensor],
           cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """One transformer block.  x: [B, S, d]."""
    B, S, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(B, S, hq, hd)
    kk = (h @ lp["wk"]).reshape(B, S, hkv, hd)
    vv = (h @ lp["wv"]).reshape(B, S, hkv, hd)
    q = apply_rope(q, cos, sin)
    kk = apply_rope(kk, cos, sin)
    attn = _attention(cfg, q, kk, vv)
    x = x + (attn.reshape(B, S, hq * hd) @ lp["wo"]).to(x.dtype)
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    gated = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
    return x + (gated @ lp["w_down"]).to(x.dtype)


def _save_matmuls(ctx, op, *args, **kwargs):
    """``"dots"`` remat: keep the (batch-free) matmul outputs, recompute
    everything else."""
    return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def forward_hidden(cfg: LlamaConfig, params: Dict[str, Any],
                   tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: [B, S] -> (final hidden [B, S, d], head [d, V])."""
    B, S = tokens.shape
    x = params["embed"][tokens]                            # [B, S, d]
    cos, sin = rope_frequencies(cfg.head_dim, S, float(cfg.rope_theta),
                                device=tokens.device)
    names = sorted(params["layers"])
    per_layer = zip(*(torch.unbind(params["layers"][n], 0) for n in names))
    if cfg.remat and cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} "
                         f"(expected 'full' or 'dots')")
    for leaves in per_layer:
        lp = dict(zip(names, leaves))
        if not cfg.remat:
            x = _layer(cfg, x, lp, cos, sin)
        elif cfg.remat_policy == "full":
            x = checkpoint(_layer, cfg, x, lp, cos, sin, use_reentrant=False)
        else:
            x = checkpoint(_layer, cfg, x, lp, cos, sin, use_reentrant=False,
                           context_fn=functools.partial(
                               create_selective_checkpoint_contexts,
                               _save_matmuls))
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return x, head


def forward(cfg: LlamaConfig, params: Dict[str, Any],
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens: [B, S] -> logits [B, S, vocab] float32."""
    x, head = forward_hidden(cfg, params, tokens)
    B, S, d = x.shape
    return logits_f32(x.reshape(B * S, d), head).reshape(B, S, -1)


def loss_fn(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor,
            targets: torch.Tensor, mask: Optional[torch.Tensor] = None,
            z_loss: float = 1e-4
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy with z-loss.  tokens/targets: [B, S];
    mask: [B, S] (1 = counts).  With ``cfg.xent_chunk`` the [B, S, V]
    logits are never formed (``ops/xent.py``, the same math)."""
    if mask is not None:
        mask = mask.float()
    if cfg.xent_chunk:
        x, head = forward_hidden(cfg, params, tokens)
        return chunked_softmax_xent_loss(
            x.reshape(-1, x.shape[-1]), head, targets.reshape(-1),
            mask=None if mask is None else mask.reshape(-1),
            z_loss=z_loss, chunk=cfg.xent_chunk)
    logits = forward(cfg, params, tokens)                  # [B, S, V] f32
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = logz - true_logit
    zl = z_loss * torch.square(logz)
    if mask is None:
        mask = torch.ones_like(nll)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = ((nll + zl) * mask).sum() / denom
    metrics = {
        "loss": (nll * mask).sum() / denom,
        "z_loss": (zl * mask).sum() / denom,
        "accuracy": ((logits.argmax(-1) == targets) * mask).sum() / denom,
    }
    return loss, metrics
