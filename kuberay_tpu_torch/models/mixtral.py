"""Mixtral-family sparse MoE transformer, in PyTorch.

Port of ``kuberay_tpu/models/mixtral.py``: the same ``MixtralConfig``
fields (``dtype`` is a torch dtype), ``CONFIGS`` keys and widths,
``param_axes`` and parameter tree (layer leaves stacked on a leading
``[n_layers]`` axis, matmul weights ``[in, out]``, expert weights
``[n_layers, E, in, out]``).  The attention half of a layer is Llama's
(RMSNorm, RoPE, the flash-attention ``autograd.Function``); the FFN is a
top-k routed expert layer:

- ``moe_ffn``: the training path, GShard/Switch capacity dispatch through
  one-hot dispatch and combine einsums, with the Switch load-balancing
  and router z aux losses;
- ``moe_ffn_dropless``: the serving path (``serve/kv_cache.py::
  forward_with_cache_mixtral``), every chosen expert always runs, through
  ``ops/moe_matmul.py::grouped_moe_ffn``.

Routing keeps the reference's arithmetic: the router product in the
working dtype, then cast to float32 (upcasting the operands first would
change which experts a bf16 token picks), and top-k by a stable
descending sort, so ties go to the lower expert index as
``jax.lax.top_k`` sends them.  The aux losses keep the reference's
choices too: ``me`` averages the router probabilities over every token
and ``ce`` counts top-1 picks over every token, masked ones included.

Neither JAX entry point takes a Mixtral config (the server reads
``llama.CONFIGS``, the train step calls ``llama.loss_fn``), so this model
is reached at library level: ``loss_fn`` for training, the two serving
engines by config type; the port's ``train_step.make_sharded_train_fns``
takes it too.

Over a ``DeviceMesh`` (``forward_hidden(..., mesh=)``, each rank holding
its shard of every leaf and its rows of the batch; ``parallel/spmd.py``)
the capacity dispatch becomes ``moe_ffn_sharded``: the router logits are
gathered over ep before top-k (ties still go to the lower expert), each
(token, k)'s place in its expert's buffer counts the earlier batch ranks'
rows (the JAX program's global cumsum, with the global capacity), the
rows within capacity run through ``grouped_moe_ffn`` on this rank's
experts, and the outputs are summed over ep (and tp).  The aux losses are
the global batch's.  Tokens are the same on every ep rank: the batch
splits over dp and fsdp only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kuberay_tpu_torch.models.llama import (
    attention_block,
    batch_count,
    embed_and_head,
    layer_axes,
    mesh_prologue,
    token_xent,
    use_layer,
)
from kuberay_tpu_torch.ops.moe_matmul import (
    dropless_reference,
    grouped_moe_ffn,
)
from kuberay_tpu_torch.ops.rmsnorm import rmsnorm
from kuberay_tpu_torch.ops.rope import rope_frequencies
from kuberay_tpu_torch.ops.xent import logits_f32
from kuberay_tpu_torch.parallel import spmd
from kuberay_tpu_torch.parallel.spmd import copy_to, gather_over, reduce_over
from kuberay_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    max_seq_len: int = 8192
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    # "auto"/"pallas" = the flash kernels (their plain versions on CPU
    # tensors); "xla" = attention_ref, as in models/llama.py.
    attn_impl: str = "auto"
    remat: bool = True
    xent_chunk: int = 0        # vocab-chunked CE (ops/xent.py); 0 = dense

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def num_params(self) -> int:
        d, f, v, L, E = (self.d_model, self.d_ff, self.vocab_size,
                         self.n_layers, self.n_experts)
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        per_layer = attn + d * E + 3 * E * d * f + 2 * d
        return 2 * v * d + L * per_layer + d


CONFIGS: Dict[str, MixtralConfig] = {
    "mixtral_tiny": MixtralConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, n_experts=4, top_k=2, max_seq_len=128,
        dtype=torch.float32, attn_impl="xla", remat=False),
    # Mixtral-8x7B's published widths; 8192: 3 full chunks + a 7424-wide
    # tail over V=32000.
    "mixtral_8x7b": MixtralConfig(xent_chunk=8192),
}


def param_axes(cfg: MixtralConfig) -> Dict[str, Any]:
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "attn_norm": ("layers", "norm"),
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv_heads"),
            "wv": ("layers", "embed", "kv_heads"),
            "wo": ("layers", "heads", "embed"),
            "mlp_norm": ("layers", "norm"),
            "router": ("layers", "embed", "expert"),
            "w_gate": ("layers", "expert", "embed", "mlp"),
            "w_up": ("layers", "expert", "embed", "mlp"),
            "w_down": ("layers", "expert", "mlp", "embed"),
        },
        "final_norm": ("norm",),
        "lm_head": ("embed", "vocab"),
    }


def init_params(cfg: MixtralConfig,
                generator: Optional[torch.Generator] = None,
                device="cuda", keep=None) -> Dict[str, Any]:
    """Scaled-normal init, the reference's tree and scales: float32
    normals from ``generator`` (on ``device``; default seed 0 there),
    each leaf cast to ``cfg.dtype``; ``device="meta"`` builds shapes only.
    To hold the two packages to one tree, convert the JAX tree with
    ``models/convert.py`` (torch draws other numbers than jax.random).
    ``keep(path, leaf)``: as in ``llama.init_params``."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    keep = keep or (lambda path, t: t)
    d, f, v, L, E = (cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers,
                     cfg.n_experts)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    std = 1.0 / math.sqrt(d)
    out_std = std / math.sqrt(2 * L)

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    def rnd(shape, scale):
        if dev.type == "meta":
            return torch.empty(shape, dtype=cfg.dtype, device=dev)
        if len(shape) == 4:
            # One layer's [E, in, out] at a time: a float32 draw of a
            # whole stacked expert leaf would be twice its bf16 size.
            out = torch.empty(shape, dtype=cfg.dtype, device=dev)
            for i in range(shape[0]):
                out[i] = rnd(shape[1:], scale)
            return out
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return w.mul_(scale).to(cfg.dtype)

    lay = ("layers",)
    return {
        "embed": keep(("embed",), rnd((v, d), std)),
        "layers": {
            "attn_norm": keep(lay + ("attn_norm",), ones(L, d)),
            "wq": keep(lay + ("wq",), rnd((L, d, hq * hd), std)),
            "wk": keep(lay + ("wk",), rnd((L, d, hkv * hd), std)),
            "wv": keep(lay + ("wv",), rnd((L, d, hkv * hd), std)),
            "wo": keep(lay + ("wo",), rnd((L, hq * hd, d), out_std)),
            "mlp_norm": keep(lay + ("mlp_norm",), ones(L, d)),
            "router": keep(lay + ("router",), rnd((L, d, E), std)),
            "w_gate": keep(lay + ("w_gate",), rnd((L, E, d, f), std)),
            "w_up": keep(lay + ("w_up",), rnd((L, E, d, f), std)),
            "w_down": keep(lay + ("w_down",), rnd((L, E, f, d), out_std)),
        },
        "final_norm": keep(("final_norm",), ones(d)),
        "lm_head": keep(("lm_head",), rnd((d, v), std)),
    }


# --------------------------------------------------------------------------
# MoE layer
# --------------------------------------------------------------------------

def route(cfg: MixtralConfig, xt: torch.Tensor, router: torch.Tensor):
    """xt [T, d] -> (float32 router logits [T, E], probabilities [T, E],
    top-k weights [T, K] renormalised, top-k expert ids [T, K]).  The
    product runs in the working dtype and is cast after; ties in the
    probabilities go to the lower expert index."""
    logits = (xt @ router).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = vals[:, :cfg.top_k], idx[:, :cfg.top_k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, topw, topi


def moe_ffn_dropless(cfg: MixtralConfig, x: torch.Tensor,
                     lp: Dict[str, torch.Tensor],
                     token_mask: Optional[torch.Tensor] = None,
                     impl: str = "grouped") -> torch.Tensor:
    """Dropless top-k MoE: every token's chosen experts always run, so a
    token's output depends on its own hidden state only (the serving
    path: no cross-request capacity contention, prefix reuse and chunked
    prefill stay exact).  ``impl="grouped"``: ``grouped_moe_ffn`` (K*T
    rows); ``"dense"``: ``dropless_reference`` (E*T rows)."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    _, _, topw, topi = route(cfg, xt, lp["router"])
    if token_mask is not None:
        topw = topw * token_mask.reshape(T, 1).to(topw.dtype)
    fn = grouped_moe_ffn if impl == "grouped" else dropless_reference
    out = fn(xt, lp["w_gate"], lp["w_up"], lp["w_down"], topi, topw)
    return out.reshape(B, S, d).to(x.dtype)


def moe_ffn(cfg: MixtralConfig, x: torch.Tensor, lp: Dict[str, torch.Tensor],
            token_mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Top-k routed expert FFN with capacity dispatch.  x: [B, S, d] ->
    (out, aux losses).

    Each expert processes at most C = max(1, ceil(T * K / E *
    capacity_factor)) (token, k) rows; a row past its expert's capacity
    drops that assignment (the token's other picks still apply).
    Positions come from a cumsum over the token-major [T * K, E]
    flattening, so earlier tokens win, then lower k.  ``token_mask`` [B,
    S] (1 = real): masked tokens claim no capacity and add no output."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    C = max(1, int(math.ceil(T * K / E * cfg.capacity_factor)))
    xt = x.reshape(T, d)
    logits, probs, topw, topi = route(cfg, xt, lp["router"])
    if token_mask is not None:
        topw = topw * token_mask.reshape(T, 1).to(topw.dtype)

    # Aux losses: Switch load balance + router z-loss.
    me = probs.mean(0)                                        # [E]
    ce = torch.zeros(E, device=x.device).index_add_(
        0, topi[:, 0], torch.ones(T, device=x.device)) / T    # top-1 share
    aux = {"load_balance": E * torch.sum(me * ce) * cfg.router_aux_weight,
           "router_z": (torch.mean(torch.logsumexp(logits, -1) ** 2)
                        * cfg.router_z_weight)}

    # Position of each (token, k) within its expert's capacity buffer.
    onehot = F.one_hot(topi, E).to(torch.int32)               # [T, K, E]
    if token_mask is not None:
        onehot = onehot * token_mask.reshape(T, 1, 1).to(torch.int32)
    flat = onehot.reshape(T * K, E)
    pos = (torch.cumsum(flat, 0) * flat - 1).reshape(T, K, E)
    # One-hot over C: pos -1 (not routed here) and pos >= C (over
    # capacity) match no slot.
    disp = (pos[..., None] == torch.arange(C, device=x.device)).to(x.dtype)
    combine = (disp * topw[..., None, None].to(x.dtype)).sum(1)  # [T, E, C]
    disp = disp.sum(1)                                        # [T, E, C]

    ex_in = torch.einsum("tec,td->ecd", disp, xt)             # [E, C, d]
    gated = F.silu(torch.einsum("ecd,edf->ecf", ex_in, lp["w_gate"])) \
        * torch.einsum("ecd,edf->ecf", ex_in, lp["w_up"])
    ex_out = torch.einsum("ecf,efd->ecd", gated, lp["w_down"])
    out = torch.einsum("tec,ecd->td", combine, ex_out)
    return out.reshape(B, S, d).to(x.dtype), aux


def _positions(flat: torch.Tensor, layout) -> torch.Tensor:
    """Each (token, k) row's 1-based place in its expert's buffer, counted
    over the global batch: this rank's cumsum plus the rows the earlier
    batch ranks (dp-major) sent to each expert."""
    pos = torch.cumsum(flat, 0)
    if layout.batch_shards > 1:
        counts = flat.sum(0)[None]                                 # [1, E]
        counts = layout.all_gather(counts, "fsdp", 0)
        counts = layout.all_gather(counts[None], "dp", 0).reshape(
            -1, flat.shape[1])                                     # [n, E]
        pos = pos + counts[:layout.batch_index].sum(0)
    return pos


def moe_ffn_sharded(cfg: MixtralConfig, x: torch.Tensor,
                    lp: Dict[str, torch.Tensor], layout,
                    token_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``moe_ffn`` over a mesh: x [B, S, d] is this rank's rows; the
    expert leaves are this rank's ep (and tp) shards.  The same outputs
    and aux losses as ``moe_ffn`` on the global batch: capacity from the
    global token count, positions from the global cumsum, the aux means
    over every token of the batch."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    T_all = T * layout.batch_shards
    C = max(1, int(math.ceil(T_all * K / E * cfg.capacity_factor)))
    xt = x.reshape(T, d)
    # The router's columns are this rank's experts: gather them over ep.
    logits = gather_over(copy_to(xt, layout, "ep") @ lp["router"], layout,
                         "ep", 1).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = vals[:, :K], idx[:, :K]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    if token_mask is not None:
        topw = topw * token_mask.reshape(T, 1).to(topw.dtype)

    # Aux losses over the global batch (masked tokens included).
    me = reduce_over(probs.sum(0), layout, "dp", "fsdp") / T_all
    top1 = torch.zeros(E, device=x.device).index_add_(
        0, topi[:, 0], torch.ones(T, device=x.device))
    ce = layout.all_reduce(top1, ("dp", "fsdp")) / T_all
    z = reduce_over(torch.sum(torch.logsumexp(logits, -1) ** 2), layout,
                    "dp", "fsdp") / T_all
    aux = {"load_balance": E * torch.sum(me * ce) * cfg.router_aux_weight,
           "router_z": z * cfg.router_z_weight}

    flat = F.one_hot(topi, E).to(torch.int32)                   # [T, K, E]
    if token_mask is not None:
        flat = flat * token_mask.reshape(T, 1, 1).to(torch.int32)
    flat = flat.reshape(T * K, E)
    pos = _positions(flat, layout).gather(1, topi.reshape(T * K, 1))
    routed = flat.gather(1, topi.reshape(T * K, 1)) > 0
    keep = (routed & (pos <= C)).reshape(T, K)
    topw = copy_to(topw * keep, layout, "ep", "tp")
    e0 = layout.index("ep") * lp["w_gate"].shape[0]
    out = grouped_moe_ffn(copy_to(xt, layout, "ep", "tp"), lp["w_gate"],
                          lp["w_up"], lp["w_down"], topi, topw, e0)
    out = reduce_over(out, layout, "ep", "tp")
    return out.reshape(B, S, d).to(x.dtype), aux


def _layer(cfg: MixtralConfig, x, lp, cos, sin, layout=None):
    lp = use_layer(lp, layout, layer_axes(param_axes(cfg)))
    x = attention_block(cfg, x, lp, cos, sin, None, layout)
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    if layout is None:
        moe_out, aux = moe_ffn(cfg, h, lp)
    else:
        moe_out, aux = moe_ffn_sharded(cfg, h, lp, layout)
    return x + moe_out, aux["load_balance"], aux["router_z"]


def forward_hidden(cfg: MixtralConfig, params: Dict[str, Any],
                   tokens: torch.Tensor, mesh=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens [B, S] -> (final hidden [B, S, d], aux losses summed over
    the layers).  With ``cfg.remat`` each layer runs under
    ``torch.utils.checkpoint`` (the JAX layer's ``jax.checkpoint``), so
    the capacity path's [T, K, E, C] one-hots are recomputed in the
    backward rather than kept.  ``mesh``: a ``DeviceMesh`` whose sp is 1
    (``tokens`` this rank's rows)."""
    B, S = tokens.shape
    layout, _ = mesh_prologue(cfg, tokens, mesh)
    if mesh is not None and (layout is None or layout.size("sp") > 1):
        raise ValueError("Mixtral runs over a DeviceMesh without sp")
    x, _ = embed_and_head(cfg, params, tokens, layout)
    cos, sin = rope_frequencies(cfg.head_dim, S, float(cfg.rope_theta),
                                device=tokens.device)
    names = sorted(params["layers"])
    lb = rz = 0.0
    for leaves in zip(*(torch.unbind(params["layers"][n], 0)
                        for n in names)):
        lp = dict(zip(names, leaves))
        if cfg.remat:
            x, a, z = checkpoint(_layer, cfg, x, lp, cos, sin, layout,
                                 use_reentrant=False)
        else:
            x, a, z = _layer(cfg, x, lp, cos, sin, layout)
        lb, rz = lb + a, rz + z
    aux = {"load_balance": lb, "router_z": rz}
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


def forward(cfg: MixtralConfig, params: Dict[str, Any], tokens: torch.Tensor,
            mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens [B, S] -> (float32 logits [B, S, V], aux losses); on a mesh
    with tp > 1, this rank's vocab / tp columns."""
    x, aux = forward_hidden(cfg, params, tokens, mesh)
    B, S, d = x.shape
    layout = spmd.layout_of(mesh)
    head = params["lm_head"] if layout is None else layout.use(
        params["lm_head"], ("embed", "vocab"))
    logits = logits_f32(copy_to(x, layout, "tp").reshape(B * S, d), head)
    return logits.reshape(B, S, -1), aux


def _share(a: torch.Tensor, n: int) -> torch.Tensor:
    """A value every batch rank holds whole, as one rank's share of it: the
    value a / n (so the ranks' shares sum to it) with a's whole gradient
    (each rank's backward reaches its own tokens only)."""
    return a / n + (a - a.detach()) * (1 - 1 / n)


def loss_fn(cfg: MixtralConfig, params: Dict[str, Any], tokens: torch.Tensor,
            targets: torch.Tensor, mask: Optional[torch.Tensor] = None,
            z_loss: float = 1e-4, mesh=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy with z-loss plus the router aux losses.
    With ``cfg.xent_chunk`` the [B, S, V] logits are never formed
    (``ops/xent.py``).  Returns (total loss, metrics: loss, total_loss,
    aux_load_balance, aux_router_z, accuracy).  On a ``DeviceMesh`` the
    loss and every metric are this rank's share: their sums over dp and
    fsdp are the global values."""
    layout = spmd.layout_of(mesh)
    x, aux = forward_hidden(cfg, params, tokens, mesh)
    head = params["lm_head"] if layout is None else layout.use(
        params["lm_head"], ("embed", "vocab"))
    nll, logz, pred = token_xent(cfg, x, head, targets, layout)
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = torch.clamp(batch_count(mask, mesh), min=1.0)
    ce = (nll * mask).sum() / denom
    zl = z_loss * ((logz ** 2) * mask).sum() / denom
    n = 1 if layout is None else layout.batch_shards
    lb, rz = _share(aux["load_balance"], n), _share(aux["router_z"], n)
    total = ce + zl + lb + rz
    accuracy = ((pred == targets) * mask).sum() / denom
    return total, {"loss": ce, "total_loss": total,
                   "aux_load_balance": lb.detach(),
                   "aux_router_z": rz.detach(), "accuracy": accuracy}
