"""Llama-3-family configuration and parameters, in PyTorch.

Port of ``kuberay_tpu/models/llama.py``: the same ``LlamaConfig`` fields
(``dtype`` is a torch dtype), the same ``CONFIGS`` keys and widths, and the
same parameter tree, a plain dict whose layer leaves are stacked on a
leading ``[n_layers]`` axis, with matmul weights stored ``[in, out]`` so
``x @ w`` reads as in the reference.  The serving path runs the model
through ``serve/kv_cache.py::forward_with_cache``; the training forward,
loss and remat come with the training port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

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
    # Training-side fields, kept so configs read as in the JAX package;
    # the serving path does not consume them.
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
