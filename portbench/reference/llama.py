"""The plain reference: a Llama-architecture decoder in float32.

Plain PyTorch operations, written from the published description of the
architecture (Llama, and Mistral-7B-v0.3 and SmolLM2, whose configs give
the same equations): token embedding; per layer x + Wo attn(RoPE(Wq h),
RoPE(Wk h), Wv h) with h = RMSNorm(x), then x + W_down(silu(W_gate h) *
W_up h) with h = RMSNorm(x); a final RMSNorm; logits against the head (the
embedding's transpose when tied).  RoPE rotates the two halves of each
head (the ``rotate_half`` convention); attention is causal with grouped
kv heads.  No kernel, cache or batching of the program is used, and
nothing of it is imported: the weights are the benchmark's
(``portbench/weights.py``), drawn again from the seed.

Precision: float32 with TF32 off (``strict_float32``); RoPE's angles in
float64.  ``Lowp`` puts every matmul's inputs through a lower precision
instead (the controls): fp8 e4m3 with a scale per row of the activations
and per output column of the weights, or int8 weights with a scale per
output column; the backward sees the rounded values and passes float32
gradients.

Training: ``loss`` is the mean over tokens of the next-token cross entropy
plus ``z_loss * logsumexp^2``, as the program's objective; ``train`` runs
that through autograd one row at a time (each layer under
``torch.utils.checkpoint``, attention a few heads at a time, so that it
fits) and applies optax's ``chain(clip_by_global_norm, adamw(
warmup_cosine_decay_schedule))`` as written in optax's documentation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.counts import Dims


def strict_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class Lowp:
    """A lower precision for the control: ``fp8`` (e4m3, activations and
    weights) or ``int8w`` (int8 weights); ``None`` is float32."""
    kind: Optional[str] = None

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind != "fp8":
            return x
        s = x.abs().amax(-1, keepdim=True).clamp(min=1e-12) / 448.0
        return _straight_through(x, (x / s).to(torch.float8_e4m3fn)
                                 .float() * s)

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp8":
            s = w.abs().amax(0, keepdim=True).clamp(min=1e-12) / 448.0
            return _straight_through(w, (w / s).to(torch.float8_e4m3fn)
                                     .float() * s)
        if self.kind == "int8w":
            s = w.abs().amax(0, keepdim=True).clamp(min=1e-12) / 127.0
            return _straight_through(
                w, torch.round(w / s).clamp(-127, 127) * s)
        return w

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.act(x) @ self.weight(w)


F32 = Lowp()


def _straight_through(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    """The rounded values forward; the gradient passes to ``x`` in float32
    (gradients are not rounded: they would underflow fp8 unscaled)."""
    return x + (rounded - x).detach()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope_tables(head_dim: int, positions: torch.Tensor, theta: float):
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64,
                                        device=positions.device) / head_dim))
    ang = positions.to(torch.float64)[:, None] * inv[None, :]
    return torch.cos(ang).float(), torch.sin(ang).float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [T, H, D]; cos/sin [T, D/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              block: int = 1024) -> torch.Tensor:
    """Causal attention, q [T, Hq, D], k/v [T, Hkv, D] -> [T, Hq, D]; a
    block of queries at a time against the keys up to its end, so the
    masked upper blocks are never computed."""
    T, hq, D = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = q.reshape(T, hkv, g, D).permute(1, 2, 0, 3)       # [Hkv, G, T, D]
    kt, vt = k.transpose(0, 1), v.transpose(0, 1)          # [Hkv, T, D]
    outs = []
    for a in range(0, T, block):
        b = min(T, a + block)
        s = torch.einsum("ngtd,nsd->ngts", qg[:, :, a:b], kt[:, :b]) \
            / math.sqrt(D)
        mask = torch.arange(a, b, device=q.device)[:, None] >= \
            torch.arange(b, device=q.device)[None, :]
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(torch.einsum("ngts,nsd->ngtd", p, vt[:, :b]))
    return torch.cat(outs, dim=2).permute(2, 0, 1, 3).reshape(T, hq, D)


def attention_chunked(q, k, v, heads_per_chunk: int) -> torch.Tensor:
    """``attention`` a few kv heads at a time, each under checkpoint, so
    the backward holds one chunk's scores at a time."""
    hkv = k.shape[1]
    g = q.shape[1] // hkv
    step = max(1, heads_per_chunk // g)
    outs = []
    for a in range(0, hkv, step):
        qs = q[:, a * g:(a + step) * g]
        ks, vs = k[:, a:a + step], v[:, a:a + step]
        if torch.is_grad_enabled():
            outs.append(checkpoint(attention, qs, ks, vs,
                                   use_reentrant=False))
        else:
            outs.append(attention(qs, ks, vs))
    return torch.cat(outs, dim=1)


def layer(x: torch.Tensor, lp: Dict[str, torch.Tensor], dims: Dims,
          eps: float, cos, sin, lowp: Lowp = F32,
          heads_per_chunk: int = 32) -> torch.Tensor:
    """One block over one sequence, x [T, d] float32."""
    T = x.shape[0]
    hd = dims.head_dim
    h = rms_norm(x, lp["attn_norm"], eps)
    q = rope(lowp.mm(h, lp["wq"]).reshape(T, -1, hd), cos, sin)
    k = rope(lowp.mm(h, lp["wk"]).reshape(T, -1, hd), cos, sin)
    v = lowp.mm(h, lp["wv"]).reshape(T, -1, hd)
    a = attention_chunked(q, k, v, heads_per_chunk)
    x = x + lowp.mm(a.reshape(T, -1), lp["wo"])
    h = rms_norm(x, lp["mlp_norm"], eps)
    ff = F.silu(lowp.mm(h, lp["w_gate"])) * lowp.mm(h, lp["w_up"])
    return x + lowp.mm(ff, lp["w_down"])


LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
              "w_up", "w_down")


def head_of(params: Dict, dims: Dims) -> torch.Tensor:
    return params["embed"].t() if dims.tied else params["lm_head"]


@torch.no_grad()
def logits_at(params: Dict, dims: Dims, eps: float, theta: float,
              tokens: Sequence[int], rows: Sequence[int],
              lowp: Lowp = F32) -> torch.Tensor:
    """float32 logits [len(rows), V] of one sequence at positions ``rows``.
    ``params``: the benchmark's tree in any float dtype; each layer's
    leaves are taken to float32 as that layer runs."""
    strict_float32()
    dev = params["embed"].device
    t = torch.as_tensor(list(tokens), device=dev, dtype=torch.long)
    cos, sin = rope_tables(dims.head_dim, torch.arange(len(t), device=dev),
                           theta)
    x = params["embed"][t].float()
    for i in range(dims.layers):
        lp = {k: params["layers"][k][i].float() for k in LAYER_KEYS}
        x = layer(x, lp, dims, eps, cos, sin, lowp, heads_per_chunk=8)
        del lp
    r = torch.as_tensor(list(rows), device=dev, dtype=torch.long)
    h = rms_norm(x[r], params["final_norm"].float(), eps)
    return lowp.mm(h, head_of(params, dims).float())


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Optim:
    """optax chain(clip_by_global_norm(grad_clip), adamw(schedule, beta1,
    beta2, eps=1e-8, weight_decay)) with
    warmup_cosine_decay_schedule(0, learning_rate, warmup, decay,
    0.1 * learning_rate)."""
    learning_rate: float
    warmup_steps: int
    decay_steps: int
    weight_decay: float
    beta1: float
    beta2: float
    grad_clip: float
    eps: float = 1e-8

    def lr(self, count: int) -> float:
        warmup = min(self.warmup_steps, max(0, self.decay_steps - 1))
        decay = max(self.decay_steps, warmup + 1)
        if count < warmup:
            return self.learning_rate * count / warmup
        t = min(count - warmup, decay - warmup)
        cosine = 0.5 * (1 + math.cos(math.pi * t / (decay - warmup)))
        return self.learning_rate * (0.9 * cosine + 0.1)


def unstack(params: Dict, dims: Dims) -> Dict:
    """The reference's own float32 copy: one tensor a layer and leaf."""
    out = {k: params[k].float().clone() for k in params if k != "layers"}
    out["layers"] = [{k: params["layers"][k][i].float().clone()
                      for k in LAYER_KEYS} for i in range(dims.layers)]
    return out


def leaves(p: Dict) -> List[torch.Tensor]:
    out = [p[k] for k in sorted(p) if k != "layers"]
    for lp in p["layers"]:
        out.extend(lp[k] for k in LAYER_KEYS)
    return out


def leaf_norms(p: Dict, fn=lambda t: t) -> Dict[str, float]:
    """Norm of each leaf of the port's stacked tree, by name
    (``layers.wq`` over every layer)."""
    out = {k: float(fn(p[k]).norm()) for k in p if k != "layers"}
    for k in LAYER_KEYS:
        out[f"layers.{k}"] = math.sqrt(sum(
            float(fn(lp[k]).norm()) ** 2 for lp in p["layers"]))
    return out


def row_loss_sum(p: Dict, dims: Dims, eps: float, theta: float,
                 tokens: torch.Tensor, targets: torch.Tensor,
                 z_loss: float, lowp: Lowp) -> torch.Tensor:
    """Sum over one row's positions of nll + z_loss * logz^2."""
    T = tokens.shape[0]
    cos, sin = rope_tables(dims.head_dim,
                           torch.arange(T, device=tokens.device), theta)
    x = p["embed"][tokens]
    for lp in p["layers"]:
        x = checkpoint(layer, x, lp, dims, eps, cos, sin, lowp, 8,
                       use_reentrant=False)
    h = rms_norm(x, p["final_norm"], eps)
    logits = lowp.mm(h, head_of(p, dims))
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - logits.gather(-1, targets[:, None])[:, 0]
    return (nll + z_loss * logz.square()).sum()


def train(params: Dict, dims: Dims, eps: float, theta: float,
          batches: Sequence[torch.Tensor], opt: Optim, z_loss: float,
          lowp: Lowp = F32, rows: Optional[slice] = None) -> Dict:
    """Follow ``len(batches)`` steps from ``params`` (the stacked tree).
    Each batch is [B, S + 1] ids.  ``rows`` keeps only those rows of every
    batch (the half-batch fault).  Returns each step's loss, the norm of
    each leaf's first gradient after clipping (as the optimizer gets it),
    and the norm of each leaf's change after the last step."""
    strict_float32()
    p0 = unstack(params, dims)
    p = {k: (v.clone() if k != "layers" else [
        {n: t.clone() for n, t in lp.items()} for lp in v])
        for k, v in p0.items()}
    mu = [torch.zeros_like(t) for t in leaves(p)]
    nu = [torch.zeros_like(t) for t in leaves(p)]
    losses: List[float] = []
    grad1: Optional[Dict[str, float]] = None
    for count, batch in enumerate(batches):
        if rows is not None:
            batch = batch[rows]
        params_list = leaves(p)
        for t in params_list:
            t.requires_grad_(True)
            t.grad = None
        n_tok = batch.shape[0] * (batch.shape[1] - 1)
        total = 0.0
        for r in range(batch.shape[0]):
            loss = row_loss_sum(p, dims, eps, theta, batch[r, :-1],
                                batch[r, 1:], z_loss, lowp) / n_tok
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            grads = [t.grad for t in params_list]
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            if float(norm) >= opt.grad_clip:
                grads = [g / norm * opt.grad_clip for g in grads]
            if grad1 is None:
                it = iter(grads)
                shadow = {k: (next(it) if k != "layers" else None)
                          for k in sorted(p) if k != "layers"}
                shadow["layers"] = [{k: next(it) for k in LAYER_KEYS}
                                    for _ in p["layers"]]
                grad1 = leaf_norms(shadow)
            c = count + 1
            bc1 = 1.0 - opt.beta1 ** c
            bc2 = 1.0 - opt.beta2 ** c
            lr = opt.lr(count)
            for t, g, m, v in zip(params_list, grads, mu, nu):
                m.mul_(opt.beta1).add_(g, alpha=1 - opt.beta1)
                v.mul_(opt.beta2).addcmul_(g, g, value=1 - opt.beta2)
                u = (m / bc1) / (torch.sqrt(v / bc2) + opt.eps)
                u = u + opt.weight_decay * t
                t.add_(u, alpha=-lr)
                t.grad = None
            for t in params_list:
                t.requires_grad_(False)
    with torch.no_grad():
        change = {}
        for k in p:
            if k != "layers":
                change[k] = float((p[k] - p0[k]).norm())
        for k in LAYER_KEYS:
            change[f"layers.{k}"] = math.sqrt(sum(
                float((a[k] - b[k]).norm()) ** 2
                for a, b in zip(p["layers"], p0["layers"])))
    return {"losses": losses, "grad1": grad1, "change": change}
