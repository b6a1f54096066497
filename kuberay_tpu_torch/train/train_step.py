"""Single-device train step: AdamW, mixed precision, gradient accumulation.

Port of ``kuberay_tpu/train/train_step.py`` (the unsharded step).  The
optimizer is written out here and reproduces optax's
``chain(clip_by_global_norm, adamw(warmup_cosine_decay_schedule))`` as the
JAX package builds it (``make_optimizer``):

- clipping scales every gradient by ``max_norm / norm`` only when the
  global norm is not below ``max_norm`` (``torch.nn.utils.clip_grad_norm_``
  divides by ``norm + 1e-6``, which is not the same);
- Adam with eps 1e-8, bias correction by the step count, the first moment
  in ``mu_dtype`` (default: the parameter's dtype);
- weight decay added to the update before the learning rate, on every
  leaf;
- the schedule read at the count before the increment (the first update
  has learning rate 0): linear warmup over ``min(warmup, decay - 1)``
  steps, then cosine decay to 0.1 x peak at ``max(decay, warmup + 1)``.

``make_sharded_train_fns`` is the step over a mesh, for Llama and Mixtral
configs:

- a ``DeviceMesh`` from ``MeshSpec.build`` / ``build_multislice``, one
  process a rank, any of dp, fsdp, tp, sp and ep larger than 1 (pp is
  ``parallel/pipeline.py``'s alone, as in the JAX package, which no train
  step calls).  Every rank holds its shard of each leaf as
  ``param_axes`` and ``DEFAULT_RULES`` place it (Adam's mu and nu follow
  the params, the counts are replicated: ``_shard_opt_like_params`` in
  the JAX package),
  takes its rows of the global batch (over the flattened dp x fsdp index)
  and its sequence shard (over sp), divides its loss sum by the global
  token count, and sums its gradients over the batch's axes
  (``parallel/spmd.py``) before clipping by the global norm (a leaf
  replicated over tp or ep counted once) and the elementwise AdamW on its
  shards;
- a ``LocalRing``: every sp rank on one device (the long-context path on
  one card), parameters replicated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from kuberay_tpu_torch.models import llama, mixtral
from kuberay_tpu_torch.parallel import spmd
from kuberay_tpu_torch.parallel.mesh import ring_of


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    z_loss: float = 1e-4
    # param_dtype: master-weight dtype ("" = the model's compute dtype); the
    # step casts the masters to cfg.dtype for the forward, so gradients and
    # Adam statistics come back in param_dtype.  mu_dtype: Adam first-moment
    # dtype ("" = the parameter's).
    param_dtype: str = ""
    mu_dtype: str = ""
    # >1 splits each batch into that many interleaved microbatches and
    # applies one optimizer update (the batch must divide by it).
    grad_accum: int = 1


def torch_dtype(name: str) -> torch.dtype:
    """The floating torch dtype called ``name`` (e.g. "float32")."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"{name!r} is not a floating dtype (use e.g. "
                         f"float32, bfloat16)")
    return dt


def tree_map(fn: Callable, *trees):
    """Map over the leaves of nested dicts with the same keys."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


class AdamW:
    """``init``/``update`` of optax's chain(clip_by_global_norm(clip),
    adamw(schedule, b1, b2, weight_decay, mu_dtype)).  The state is
    {"count", "mu", "nu"}; the one count serves Adam's bias correction and
    the schedule, which optax keeps in two states that always agree."""

    eps = 1e-8

    def __init__(self, tc: TrainConfig):
        self.tc = tc
        self.warmup = min(tc.warmup_steps, max(0, tc.decay_steps - 1))
        self.decay = max(tc.decay_steps, self.warmup + 1)
        self.mu_dtype = torch_dtype(tc.mu_dtype) if tc.mu_dtype else None

    def schedule(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay,
        0.1 * lr) at ``count``."""
        peak = self.tc.learning_rate
        if count < self.warmup:
            return peak * count / self.warmup
        alpha = 0.1 if peak != 0.0 else 0.0
        span = self.decay - self.warmup
        t = min(count - self.warmup, span)
        cosine = 0.5 * (1 + math.cos(math.pi * t / span))
        return peak * ((1 - alpha) * cosine + alpha)

    def init(self, params) -> Dict[str, Any]:
        return {"count": 0,
                "mu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=self.mu_dtype or p.dtype), params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(self, grads, state, params, norm=None
               ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(updates, new state); ``params + updates`` is the new params.
        ``norm``: the gradients' global norm (default: over ``grads``,
        which must then be whole leaves)."""
        tc = self.tc
        norm = global_norm(grads) if norm is None else norm
        keep = norm < tc.grad_clip
        count = state["count"] + 1
        # 1 - b**count in f32, as optax computes it, then rounded to each
        # moment's dtype; the step size likewise in each update's dtype.
        bc1 = 1.0 - torch.tensor(tc.beta1) ** count
        bc2 = 1.0 - torch.tensor(tc.beta2) ** count
        neg_lr = torch.tensor(-self.schedule(state["count"]))

        def as_dtype(x: torch.Tensor, dtype) -> float:
            return float(x.to(dtype))

        def leaf(g, mu, nu, p):
            g = torch.where(keep, g, (g / norm.to(g.dtype)) * tc.grad_clip)
            mu = (1 - tc.beta1) * g + tc.beta1 * mu
            nu = (1 - tc.beta2) * torch.square(g) + tc.beta2 * nu
            u = (mu / as_dtype(bc1, mu.dtype)) / (
                torch.sqrt(nu / as_dtype(bc2, nu.dtype)) + self.eps)
            u = u + tc.weight_decay * p
            u = as_dtype(neg_lr, u.dtype) * u
            return u, mu.to(self.mu_dtype) if self.mu_dtype else mu, nu

        out = tree_map(leaf, grads, state["mu"], state["nu"], params)
        updates = tree_map(lambda t: t[0], out)
        mus = tree_map(lambda t: t[1], out)
        nus = tree_map(lambda t: t[2], out)
        return updates, {"count": count, "mu": mus, "nu": nus}


def make_optimizer(tc: TrainConfig) -> AdamW:
    return AdamW(tc)


def apply_updates(params, updates):
    """``params + updates`` in each parameter's dtype (optax's
    ``apply_updates``)."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _cast_floating(tree, dtype: torch.dtype):
    """Cast every floating leaf (integer/bool leaves untouched)."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def model_of(cfg):
    """The model module of a config: ``mixtral`` or ``llama``."""
    return mixtral if isinstance(cfg, mixtral.MixtralConfig) else llama


def _init_params(cfg, generator, param_dtype: str, device):
    params = model_of(cfg).init_params(cfg, generator, device)
    if param_dtype:
        params = _cast_floating(params, torch_dtype(param_dtype))
    return params


def init_train_state(cfg: llama.LlamaConfig, optimizer: AdamW,
                     generator=None, param_dtype: str = "",
                     device="cuda") -> Dict[str, Any]:
    """Seeded init (the model's ``init_params``), cast to
    ``param_dtype``."""
    params = _init_params(cfg, generator, param_dtype, device)
    return {"step": 0, "params": params,
            "opt_state": optimizer.init(params)}


def _compute_cast(cfg, tc: TrainConfig, params):
    """Master weights -> compute dtype for the forward (no-op when they
    already match).  The cast is recorded, so gradients come back in the
    master dtype."""
    if not tc.param_dtype or torch_dtype(tc.param_dtype) == cfg.dtype:
        return params
    return _cast_floating(params, cfg.dtype)


def _value_and_grad(loss_fn: Callable, params, batch):
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, aux = loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()}), \
        tree_map(lambda _: next(it), leaves)


def _value_and_grad_accum(loss_fn: Callable, params, batch, accum: int,
                          total: Optional[Callable] = None):
    """Loss, aux and gradients, optionally accumulated over ``accum``
    microbatches.  The split is interleaved (microbatch k takes rows k,
    k + A, k + 2A, ...), each microbatch is weighted by its real token
    count (the mask's sum; ``total`` sums it over sp), and sums are kept in
    f32, so a masked batch gives the full batch's masked mean.  Aux metrics
    get the same weights.  ``loss_fn(params, batch) -> (loss, aux)``."""
    if accum <= 1:
        return _value_and_grad(loss_fn, params, batch)
    B = batch["tokens"].shape[0]
    if B % accum:
        raise ValueError(f"batch {B} not divisible by grad_accum {accum}")
    gsum, lsum, wsum, auxsum = None, 0.0, 0.0, None
    for k in range(accum):
        mb = {name: t[k::accum] for name, t in batch.items()}
        (l, aux), g = _value_and_grad(loss_fn, params, mb)
        m = mb.get("mask")
        w = (m.float().sum() if m is not None else torch.tensor(
            float(mb["tokens"].numel()), device=l.device))
        if total is not None:
            w = total(w)
        gw = tree_map(lambda x: x.float() * w, g)
        gsum = gw if gsum is None else tree_map(torch.add, gsum, gw)
        aw = {n: a * w for n, a in aux.items()}
        auxsum = aw if auxsum is None else {
            n: auxsum[n] + aw[n] for n in aw}
        lsum = lsum + l * w
        wsum = wsum + w
    grads = tree_map(lambda s, p: (s / wsum).to(p.dtype), gsum, params)
    aux = {n: a / wsum for n, a in auxsum.items()}
    return (lsum / wsum, aux), grads


def _make_step(cfg: llama.LlamaConfig, tc: TrainConfig, optimizer: AdamW,
               mesh=None) -> Callable:
    model = model_of(cfg)
    layout = spmd.layout_of(mesh)
    axes = model.param_axes(cfg)

    def step(state, batch, rows_local=False):
        def loss(params, b):
            return model.loss_fn(cfg, _compute_cast(cfg, tc, params),
                                 b["tokens"], b["targets"], b.get("mask"),
                                 tc.z_loss, mesh=mesh)

        if layout is not None:
            batch = layout.local_batch(batch, rows=not rows_local)
        (l, metrics), grads = _value_and_grad_accum(
            loss, state["params"], batch, tc.grad_accum,
            None if layout is None else layout.sum_batch)
        if layout is None:
            norm = global_norm(grads)
        else:
            grads = layout.grad_sync(grads, axes)
            l = layout.sum_batch(l)
            metrics = {k: layout.sum_batch(v) for k, v in metrics.items()}
            norm = layout.global_norm(grads, axes)
        updates, new_opt = optimizer.update(grads, state["opt_state"],
                                            state["params"], norm)
        new_params = apply_updates(state["params"], updates)
        metrics["grad_norm"] = norm
        metrics["total_loss"] = l
        return {"step": state["step"] + 1, "params": new_params,
                "opt_state": new_opt}, metrics

    return step


def make_train_step(cfg: llama.LlamaConfig, tc: TrainConfig,
                    optimizer: AdamW) -> Callable:
    """step(state, batch) -> (new state, metrics).  ``batch``: tokens,
    targets and an optional mask, [B, S] tensors on the params' device.
    Metrics: loss, z_loss, accuracy, grad_norm (before clipping) and
    total_loss, as 0-d tensors."""
    return _make_step(cfg, tc, optimizer)


def param_shardings(cfg, layout: "spmd.Layout") -> Dict[str, Any]:
    """Each param leaf's ``spmd.LeafSpec`` on ``layout``, by its logical
    axes and ``DEFAULT_RULES``."""
    return tree_map(lambda a: spmd.LeafSpec(layout, a),
                    model_of(cfg).param_axes(cfg))


def state_shardings(cfg, layout: "spmd.Layout") -> Dict[str, Any]:
    """Each state leaf's ``spmd.LeafSpec``: the params', Adam's mu and nu
    like the params (``_shard_opt_like_params`` in the JAX package), the
    step and count replicated."""
    p = param_shardings(cfg, layout)
    rep = spmd.LeafSpec(layout, ())
    return {"step": rep, "params": p,
            "opt_state": {"count": rep, "mu": p, "nu": p}}


def make_sharded_train_fns(cfg: llama.LlamaConfig, tc: TrainConfig, mesh
                           ) -> Tuple[Callable, Callable, Dict[str, Any]]:
    """(init, step, shardings) over ``mesh``: a ``DeviceMesh`` built by
    ``MeshSpec`` (one process a rank; every axis but pp) or a
    ``LocalRing`` (the sp ranks on one device).

    ``init(generator=None)`` builds the seeded state (default generator:
    seed 0 on the mesh's device; every rank draws the same global leaves)
    already laid out: this rank's shard of each leaf.  ``step(state,
    batch)`` takes the global [B, S] batch (B divisible by dp x fsdp and
    by ``grad_accum``, S by sp; with ``rows_local=True``, this rank's rows
    of it), uses this rank's part, and returns (new
    state, metrics) as ``make_train_step``'s; the loss and metrics are the
    global batch's on every rank.  ``shardings``: on a ``DeviceMesh``
    ``state_shardings`` (each leaf's placements and its chunk), on a
    ``LocalRing`` a description."""
    optimizer = make_optimizer(tc)
    layout = spmd.layout_of(mesh)
    if layout is None:
        ring = ring_of(mesh)

        def init(generator=None):
            return init_train_state(cfg, optimizer, generator,
                                    tc.param_dtype, ring.device)

        shardings = {"params": "replicated over sp",
                     "opt_state": "replicated over sp",
                     "batch": "[B, S]: S split into sp equal shards"}
        return init, _make_step(cfg, tc, optimizer, mesh), shardings

    spmd.check_divisible(cfg, layout)
    shardings = state_shardings(cfg, layout)

    def init(generator=None):
        full = _init_params(cfg, generator, tc.param_dtype, layout.device)
        params = tree_map(lambda t, spec: spec.shard(t), full,
                          shardings["params"])
        del full
        return {"step": 0, "params": params,
                "opt_state": optimizer.init(params)}

    return init, _make_step(cfg, tc, optimizer, mesh), shardings
