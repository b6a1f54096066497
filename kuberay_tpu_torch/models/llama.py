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

Sequence parallelism (``attn_impl="ring"`` / ``"ring_rdma"``, the
long-context training path): ``forward_hidden`` / ``forward`` /
``loss_fn`` take ``mesh=``, a ``LocalRing`` (one device holds every sp
rank; tensors carry the whole sequence) or a ``DeviceMesh`` (each process
passes its own sequence shard and gets its shard's outputs back, with RoPE
at the shard's global positions).  The loss divides each rank's sum by
the global token count; the sum of the ranks' losses is the JAX loss.

On a ``DeviceMesh`` with any other axis larger than 1 (the multi-process
layouts of ``train_step.make_sharded_train_fns``), ``params`` holds this
rank's shard of every leaf as ``param_axes`` and ``DEFAULT_RULES`` place
it, and ``tokens`` its rows (and sequence shard) of the batch.  The
collectives GSPMD inserts in the JAX package are called here
(``parallel/spmd.py``): each layer gathers its fsdp-split leaves,
attention runs the flash kernels (or the ring) on this rank's tp heads,
RMSNorm on the replicated activations, the row-parallel products are
summed over tp, the embedding and the cross entropy are vocab-parallel.
``forward`` then returns this rank's vocabulary columns of the logits.
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
from kuberay_tpu_torch.ops.xent import chunked_xent, logits_f32
from kuberay_tpu_torch.parallel import spmd
from kuberay_tpu_torch.parallel.mesh import ring_of
from kuberay_tpu_torch.parallel.ring import ring_attention
from kuberay_tpu_torch.parallel.spmd import copy_to, reduce_over
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
    # package's "xla" names; "ring" = the plain sequence-parallel ring over
    # the mesh's sp axis, "ring_rdma" = the ring with the CUDA ring kernel
    # (parallel/ring.py; forward() must receive the mesh).
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


def param_axes(cfg: LlamaConfig) -> Dict[str, Any]:
    """Logical sharding axes per leaf, the params' tree (copied)."""
    axes = {
        "embed": ("vocab", "embed"),
        "layers": {
            "attn_norm": ("layers", "norm"),
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv_heads"),
            "wv": ("layers", "embed", "kv_heads"),
            "wo": ("layers", "heads", "embed"),
            "mlp_norm": ("layers", "norm"),
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "final_norm": ("norm",),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def init_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
                device="cuda", keep=None) -> Dict[str, Any]:
    """Scaled-normal init (GPT-NeoX style residual scaling on out-projs),
    the reference's tree and scales.  Draws float32 normals from
    ``generator`` (which must live on ``device``; default: seed 0 there)
    and casts each leaf to ``cfg.dtype``.  ``device="meta"`` builds shapes
    only.  torch's generator draws other numbers than ``jax.random``: to
    hold the two packages to one tree, convert the JAX tree with
    ``models/convert.py``.  ``keep(path, leaf)``, where given, replaces
    each leaf as soon as it is made (``path``: its keys, e.g. ``("layers",
    "wq")``), so that a rank can keep its shard and free the rest
    (``serve/sharding.py::init_sharded_params``); the draws are the
    same."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    keep = keep or (lambda path, t: t)
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    std = 1.0 / math.sqrt(d)
    out_std = std / math.sqrt(2 * L)

    def norm_init(path, *shape):
        return keep(path, torch.ones(shape, dtype=cfg.dtype, device=dev))

    def rnd(path, shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        w = w.mul_(scale).to(cfg.dtype)     # the float32 draw is freed here
        return keep(path, w)

    lay = ("layers",)
    params = {
        "embed": rnd(("embed",), (v, d), std),
        "layers": {
            "attn_norm": norm_init(lay + ("attn_norm",), L, d),
            "wq": rnd(lay + ("wq",), (L, d, hq * hd), std),
            "wk": rnd(lay + ("wk",), (L, d, hkv * hd), std),
            "wv": rnd(lay + ("wv",), (L, d, hkv * hd), std),
            "wo": rnd(lay + ("wo",), (L, hq * hd, d), out_std),
            "mlp_norm": norm_init(lay + ("mlp_norm",), L, d),
            "w_gate": rnd(lay + ("w_gate",), (L, d, f), std),
            "w_up": rnd(lay + ("w_up",), (L, d, f), std),
            "w_down": rnd(lay + ("w_down",), (L, f, d), out_std),
        },
        "final_norm": norm_init(("final_norm",), d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = rnd(("lm_head",), (d, v), std)
    return params


# --------------------------------------------------------------------------
# Training forward and loss
# --------------------------------------------------------------------------

_RING = ("ring", "ring_rdma")


def _attention(cfg: LlamaConfig, q, k, v, mesh):
    if cfg.attn_impl in _RING:
        if mesh is None:
            raise ValueError(
                f"attn_impl={cfg.attn_impl!r} requires forward(..., mesh=)")
        return ring_attention(
            q, k, v, mesh, causal=True,
            impl="rdma" if cfg.attn_impl == "ring_rdma" else "ppermute")
    if cfg.attn_impl == "xla":
        return attention_ref(q, k, v, causal=True)
    if cfg.attn_impl in ("auto", "pallas", "pallas_interpret"):
        return flash_attention(q, k, v, causal=True)
    raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


def use_layer(lp: Dict[str, torch.Tensor], layout,
              layer_axes: Dict[str, Tuple]) -> Dict[str, torch.Tensor]:
    """One layer's leaves as the layer uses them: fsdp-split ones
    gathered (``Layout.use``); without a layout, as they are."""
    if layout is None:
        return lp
    return {n: layout.use(w, layer_axes[n]) for n, w in lp.items()}


def layer_axes(axes: Dict[str, Any]) -> Dict[str, Tuple]:
    """Logical axes of one layer's leaves (the stacked axis dropped)."""
    return {n: a[1:] for n, a in axes["layers"].items()}


def attention_block(cfg, x: torch.Tensor, lp: Dict[str, torch.Tensor],
                    cos: torch.Tensor, sin: torch.Tensor, mesh=None,
                    layout=None) -> torch.Tensor:
    """x + attention(RMSNorm(x)): the first half of a Llama or Mixtral
    block.  Under tp the projections hold this rank's heads and the output
    projection's partial sums are added over tp."""
    B, S, d = x.shape
    hd = cfg.head_dim
    h = copy_to(rmsnorm(x, lp["attn_norm"], cfg.norm_eps), layout, "tp")
    q = (h @ lp["wq"]).reshape(B, S, -1, hd)
    kk = (h @ lp["wk"]).reshape(B, S, -1, hd)
    vv = (h @ lp["wv"]).reshape(B, S, -1, hd)
    q = apply_rope(q, cos, sin)
    kk = apply_rope(kk, cos, sin)
    attn = _attention(cfg, q, kk, vv, mesh)
    return x + reduce_over(attn.reshape(B, S, -1) @ lp["wo"], layout,
                           "tp").to(x.dtype)


def _layer(cfg: LlamaConfig, x: torch.Tensor, lp: Dict[str, torch.Tensor],
           cos: torch.Tensor, sin: torch.Tensor, mesh=None,
           layout=None) -> torch.Tensor:
    """One transformer block.  x: [B, S, d]."""
    lp = use_layer(lp, layout, layer_axes(param_axes(cfg)))
    x = attention_block(cfg, x, lp, cos, sin, mesh, layout)
    h = copy_to(rmsnorm(x, lp["mlp_norm"], cfg.norm_eps), layout, "tp")
    gated = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
    return x + reduce_over(gated @ lp["w_down"], layout, "tp").to(x.dtype)


def _save_matmuls(ctx, op, *args, **kwargs):
    """``"dots"`` remat: keep the (batch-free) matmul outputs, recompute
    everything else."""
    return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def mesh_prologue(cfg, tokens: torch.Tensor, mesh):
    """(layout, the sequence offset of ``tokens``) for a forward over
    ``mesh``: the ``Layout`` of a ``DeviceMesh`` (its dims checked against
    the config), and RoPE's offset of this rank's sequence shard."""
    layout = spmd.layout_of(mesh)
    if layout is None:
        return None, 0
    spmd.check_divisible(cfg, layout)
    if layout.size("sp") > 1 and cfg.attn_impl not in _RING:
        raise ValueError(f"a DeviceMesh with sp > 1 shards the sequence: "
                         f"attn_impl must be one of {_RING}, not "
                         f"{cfg.attn_impl!r}")
    return layout, ring_of(mesh).seq_offset(tokens.shape[1])


def embed_and_head(cfg, params: Dict[str, Any], tokens: torch.Tensor,
                   layout) -> Tuple[torch.Tensor, Any]:
    """(the token embeddings [B, S, d], a function giving the head [d, V]
    or this rank's [d, V / tp] columns of it)."""
    if layout is None:
        x = params["embed"][tokens]
        return x, lambda: (params["embed"].t() if cfg.tie_embeddings
                           else params["lm_head"])
    table = layout.use(params["embed"], ("vocab", "embed"))
    x = spmd.embed_lookup(table, tokens, layout)

    def head():
        if cfg.tie_embeddings:
            return table.t()
        return layout.use(params["lm_head"], ("embed", "vocab"))
    return x, head


def forward_hidden(cfg: LlamaConfig, params: Dict[str, Any],
                   tokens: torch.Tensor, mesh=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: [B, S] -> (final hidden [B, S, d], head [d, V]).  On a
    ``DeviceMesh`` ``tokens`` is this rank's rows and sequence shard, and
    the head this rank's vocabulary columns."""
    B, S = tokens.shape
    layout, off = mesh_prologue(cfg, tokens, mesh)
    x, head = embed_and_head(cfg, params, tokens, layout)  # [B, S, d]
    # RoPE at global positions: the table's rows [off, off + S).
    cos, sin = rope_frequencies(cfg.head_dim, off + S, float(cfg.rope_theta),
                                device=tokens.device)
    cos, sin = cos[off:], sin[off:]
    names = sorted(params["layers"])
    per_layer = zip(*(torch.unbind(params["layers"][n], 0) for n in names))
    if cfg.remat and cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} "
                         f"(expected 'full' or 'dots')")
    for leaves in per_layer:
        lp = dict(zip(names, leaves))
        if not cfg.remat:
            x = _layer(cfg, x, lp, cos, sin, mesh, layout)
        elif cfg.remat_policy == "full":
            x = checkpoint(_layer, cfg, x, lp, cos, sin, mesh, layout,
                           use_reentrant=False)
        else:
            x = checkpoint(_layer, cfg, x, lp, cos, sin, mesh, layout,
                           use_reentrant=False,
                           context_fn=functools.partial(
                               create_selective_checkpoint_contexts,
                               _save_matmuls))
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, head()


def forward(cfg: LlamaConfig, params: Dict[str, Any],
            tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """tokens: [B, S] -> logits [B, S, vocab] float32 (on a mesh with tp >
    1, this rank's vocab / tp columns).  ``mesh`` is required for
    attn_impl "ring" / "ring_rdma"."""
    x, head = forward_hidden(cfg, params, tokens, mesh)
    B, S, d = x.shape
    x = copy_to(x, spmd.layout_of(mesh), "tp")
    return logits_f32(x.reshape(B * S, d), head).reshape(B, S, -1)


def token_xent(cfg, x: torch.Tensor, head: torch.Tensor,
               targets: torch.Tensor, layout
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(nll, logz, pred), each [B, S], from the final hidden states and
    the head: chunked over the vocabulary with ``cfg.xent_chunk``, and
    vocab-parallel over tp (every tp rank gets the whole vocabulary's)."""
    B, S, d = x.shape
    tp = layout is not None and layout.size("tp") > 1
    x = copy_to(x, layout, "tp").reshape(B * S, d)
    if cfg.xent_chunk:
        out = chunked_xent(x, head, targets.reshape(-1), cfg.xent_chunk,
                           layout if tp else None)
        return tuple(t.reshape(B, S) for t in out)
    logits = logits_f32(x, head).reshape(B, S, -1)
    if tp:
        return spmd.vocab_xent(logits, targets, layout)
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - logits.gather(-1, targets.long()[..., None])[..., 0]
    return nll, logz, logits.argmax(-1)


def batch_count(mask: torch.Tensor, mesh) -> torch.Tensor:
    """The mask's sum over the global batch (no gradient): summed over the
    axes that split the batch on a ``DeviceMesh``, over sp on a ring."""
    count = mask.sum()
    layout = spmd.layout_of(mesh)
    if layout is not None:
        return layout.sum_batch(count)
    if mesh is not None:
        return ring_of(mesh).sum(count.detach())
    return count


def loss_fn(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor,
            targets: torch.Tensor, mask: Optional[torch.Tensor] = None,
            z_loss: float = 1e-4, mesh=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy with z-loss.  tokens/targets: [B, S];
    mask: [B, S] (1 = counts).  With ``cfg.xent_chunk`` the [B, S, V]
    logits are never formed (``ops/xent.py``, the same math).  With a
    ``mesh`` every sum is divided by the token count summed over the
    ranks that split the batch (dp, fsdp, sp; no gradient), so on a
    ``DeviceMesh`` each rank returns its share and the sum over those
    ranks is the global loss and metrics."""
    x, head = forward_hidden(cfg, params, tokens, mesh)
    nll, logz, pred = token_xent(cfg, x, head, targets, spmd.layout_of(mesh))
    zl = z_loss * torch.square(logz)
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = torch.clamp(batch_count(mask, mesh), min=1.0)
    loss = ((nll + zl) * mask).sum() / denom
    metrics = {
        "loss": (nll * mask).sum() / denom,
        "z_loss": (zl * mask).sum() / denom,
        "accuracy": ((pred == targets) * mask).sum() / denom,
    }
    return loss, metrics
