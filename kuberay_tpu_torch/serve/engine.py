"""Continuous-batching inference engine, in PyTorch.

Port of ``kuberay_tpu/serve/engine.py::ServeEngine``: a fixed slot count
over a static dense KV cache (bf16, or int8 with ``kv_quant="int8"``); new
requests prefill into free slots while the others keep decoding; prompt
lengths are bucketed to powers of two; greedy, temperature, top-p and
top-k sampling per request; eos and stop tokens; TTFT per request.  The
host loop does bookkeeping only; every step runs
``serve/kv_cache.py::forward_with_cache`` (or its int8 wrapper) on the
engine's device.  The paged engine (``serve/paged_engine.py``) subclasses
it through the hooks ``_init_cache``, ``_base_forward``,
``_prefill_forward``, ``_decode_forward``, ``_admit``, ``_begin_chunked``,
``_chunk_finalize`` and ``_extra_draft_cap``.

Options, as in the JAX engine:
- ``prefill_chunk`` > 0: chunked prefill.  A prompt streams into its slot
  in chunks of that many tokens, at most one chunk per engine step, with a
  decode pass over the other slots in between;
- ``speculative`` = gamma > 0: prompt-lookup speculation for greedy slots.
  Drafts come from the slot's own history (``NgramIndex``); one verify
  forward of gamma + 1 tokens per slot emits the longest prefix the model
  agrees with, plus its correction, and reproduces sequential greedy
  decoding;
- ``weight_quant="int8"``: W8A16 weights (``serve/weight_quant.py``),
  dequantised a layer at a time inside the forward;
- ``metrics``: a ``utils/metrics.py::MetricsRegistry`` that receives the
  request-phase histogram ``tpu_serve_request_duration_seconds`` (queue,
  prefill, decode, and the TTFT);
- ``tracer``: requests that carry a ``TraceContext`` get engine-queue,
  prefill, kv-alloc and decode spans (the no-op tracer by default).  Every
  ``step()`` is a trace of its own: an ``engine-step`` root over
  ``step-admit`` (or ``step-chunk``) and ``step-decode`` (its verify pass
  under ``step-verify``), and inside those the device funnels' enqueue
  and sync spans (``prefill-``, ``decode-``, ``verify-enqueue`` /
  ``-sync``) and the token emission (``decode-emit``, ``verify-emit``);
  ``decode-enqueue`` carries ``step``, what ``decode_steps`` reads once
  that decode step is done.
  Under a ``torch.profiler`` capture each is also a profiler range, with
  either tracer.  Span stamps, request arrivals and phase marks are on
  the tracer's clock (``time.perf_counter``);
- ``layout``: tensor parallelism (the JAX engine's ``mesh=``), this
  rank's serving layout (``serve/sharding.py``).  ``params`` are then the
  rank's shards, the cache holds the rank's kv heads, int8 weights are
  quantised after sharding, and every forward runs the group's
  collectives; one process per card, kept in lockstep by
  ``serve/multihost.py``.  The host loop does not change.

Chunks and verify steps run T > 1 query tokens through the plain
multi-token attention, as the JAX package runs them through XLA; only
one-token decode steps launch a decode-attention kernel.

Where the JAX prefill runs every slot's row (one of them real) and computes
logits at every position, this one prefills only the target slot and takes
logits at its last real token: the other rows were write-masked anyway, so
the slot's result is the same, and at Llama-3-8B width it avoids gigabytes
of float32 logits.

The model is Llama or, for a ``MixtralConfig``, Mixtral (the dropless
MoE FFN of ``forward_with_cache_mixtral``), picked by config type as the
JAX engines pick it.

Random draws use a ``torch.Generator`` on the engine's device, so sampled
(temperature > 0) tokens differ from the JAX engine's; greedy tokens do
not depend on the generator.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from kuberay_tpu_torch.models.llama import LlamaConfig
from kuberay_tpu_torch.obs.trace import NOOP_TRACER
from kuberay_tpu_torch.serve.kv_cache import (
    base_forward_for,
    forward_with_cache,
    init_kv_cache,
    make_quantized_forward,
    tree_map,
)
from kuberay_tpu_torch.serve.sharding import (
    check_local_params,
    local_kv_heads,
    param_axes_of,
    validate_tp,
)
from kuberay_tpu_torch.serve.weight_quant import (
    make_weight_dequant_forward,
    quantize_weights,
)
from kuberay_tpu_torch.utils.device import resolve_device
from kuberay_tpu_torch.utils.metrics import SERVE_LATENCY_BUCKETS


@dataclasses.dataclass
class Request:
    request_id: str
    prompt_tokens: List[int]
    max_new_tokens: int = 64
    temperature: float = 0.0          # 0 = greedy
    top_p: float = 1.0                # nucleus sampling (1 = off)
    top_k: int = 0                    # top-k sampling (0 = off)
    eos_token: Optional[int] = None
    # Additional stop tokens (any match ends generation, reason "eos").
    stop_token_ids: Optional[List[int]] = None
    # Trace context (obs/trace.py::TraceContext) adopted from the
    # request's ``traceparent``; None = untraced.
    trace: Optional[Any] = None


@dataclasses.dataclass
class Response:
    request_id: str
    tokens: List[int]                 # generated tokens (no prompt)
    finish_reason: str = "length"     # length|eos|cancelled|preempted
    prompt_len: int = 0
    created: float = 0.0
    # Enqueue -> first-token seconds (None for cancelled requests).
    ttft_s: Optional[float] = None


def _bucket(n: int, max_len: int = 2048) -> int:
    """Smallest power-of-two bucket >= n, capped at max_len."""
    b = 32
    while b < n and b < max_len:
        b *= 2
    return min(b, max_len)


def prompt_lookup_draft(hist: List[int], gamma: int, ngram: int = 3,
                        window: int = 4096) -> List[int]:
    """Prompt-lookup drafting: if the history's suffix n-gram occurred
    earlier (within ``window``), propose the tokens that followed its
    latest occurrence; longest n-gram first.  The O(len(hist)) reference
    scan; the engine uses ``NgramIndex`` (the same drafts)."""
    lo = max(0, len(hist) - window)
    for n in range(min(ngram, len(hist) - 1), 0, -1):
        pat = hist[-n:]
        for k in range(len(hist) - n - 1, lo - 1, -1):
            if hist[k:k + n] == pat:
                cont = hist[k + n:k + n + gamma]
                if cont:
                    return list(cont)
    return []


class NgramIndex:
    """Incremental n-gram -> latest start position index over one slot's
    history: ``extend`` costs O(new tokens), ``draft`` O(gamma).  Drafts
    equal ``prompt_lookup_draft``'s: longest n-gram first, latest
    occurrence wins, occurrences end before the history's last position
    (the suffix never matches itself)."""

    PRUNE_EVERY = 1024         # tokens between out-of-window evictions

    def __init__(self, ngram: int = 3, window: int = 4096):
        self.n_max = ngram
        self.window = window
        self.maps = {n: {} for n in range(1, ngram + 1)}
        self.indexed = 0         # history length already processed

    def extend(self, hist: List[int]) -> None:
        L = len(hist)
        for n, m in self.maps.items():
            # Ascending order keeps "latest occurrence wins".
            for k in range(max(0, self.indexed - n), L - n):
                m[tuple(hist[k:k + n])] = k
        # Entries whose latest occurrence fell behind the window are never
        # drafted from; dropping them bounds the maps by the window.
        if L // self.PRUNE_EVERY > self.indexed // self.PRUNE_EVERY:
            floor = L - self.window
            for m in self.maps.values():
                for key in [t for t, k in m.items() if k < floor]:
                    del m[key]
        self.indexed = L

    def draft(self, hist: List[int], gamma: int) -> List[int]:
        for n in range(min(self.n_max, len(hist) - 1), 0, -1):
            k = self.maps[n].get(tuple(hist[-n:]))
            # A latest occurrence older than the window means none is in
            # it: fall through to a shorter n-gram.
            if k is not None and k >= len(hist) - self.window:
                return list(hist[k + n:k + n + gamma])
        return []


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


class ServeEngine:
    SPEC_MISS_LIMIT = 3        # consecutive full rejects before backoff
    SPEC_PROBE_EVERY = 8       # steps between probes while backed off
    # A verify step costs every active slot a (gamma+1)-token forward, so
    # speculate only when at least this share of active slots drafted.
    SPEC_MIN_DRAFT_FRACTION = 0.25

    def __init__(self, cfg: LlamaConfig, params: Dict[str, Any],
                 max_slots: int = 8, max_len: int = 2048,
                 rng_seed: int = 0, device="cuda", kv_quant: str = "none",
                 prefill_chunk: int = 0, speculative: int = 0,
                 weight_quant: str = "none", donate_params: bool = False,
                 metrics=None, tracer=None, layout=None):
        self.device = resolve_device(device)
        if layout is not None:
            validate_tp(cfg, layout)
            check_local_params(cfg, params, layout)
        self.layout = layout
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        if max_len > cfg.max_seq_len:
            raise ValueError(f"max_len {max_len} exceeds the model's "
                             f"max_seq_len {cfg.max_seq_len}")
        if weight_quant not in ("none", "int8"):
            raise ValueError(f"unknown weight_quant {weight_quant!r}")
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.kv_quant = kv_quant
        self.prefill_chunk = prefill_chunk
        self._inflight = None        # (req, slot, prompt offset) mid-chunking
        self.speculative = speculative
        self.spec_stats = {"drafted": 0, "accepted": 0, "verify_steps": 0}
        # Backoff: a slot whose last SPEC_MISS_LIMIT drafts were all
        # rejected pauses drafting for SPEC_PROBE_EVERY steps, then probes.
        self._spec_miss = np.zeros(max_slots, dtype=np.int32)
        self._spec_cooldown = np.zeros(max_slots, dtype=np.int32)
        self._spec_index: List[Optional[NgramIndex]] = [None] * max_slots
        self.metrics = metrics
        self._tracer = tracer if tracer is not None else NOOP_TRACER
        if metrics is not None:
            metrics.describe(
                "tpu_serve_request_duration_seconds",
                "Per-request wall time by phase (queue | prefill | decode)")
        self._req_phase_ts: Dict[str, Dict[str, float]] = {}
        self.cache = self._init_cache()
        self.weight_quant = weight_quant
        self._forward = self._base_forward()
        if weight_quant == "int8":
            # ``donate_params``: the caller hands the tree over and each
            # bf16 leaf is freed once quantised.
            params = quantize_weights(
                params, donate=donate_params, layout=layout,
                axes=param_axes_of(cfg) if layout is not None else None)
            self._forward = make_weight_dequant_forward(self._forward)
        self.params = params
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rng_seed)
        # Streaming hook: token_callback(request_id, [tokens]) as tokens are
        # emitted.  Runs on the engine thread; must be cheap and not raise.
        self.token_callback = None

        # Slot bookkeeping (host side).
        self.lens = np.zeros(max_slots, dtype=np.int32)       # cache length
        self.active: List[Optional[Request]] = [None] * max_slots
        self.generated: List[List[int]] = [[] for _ in range(max_slots)]
        self.budget = np.zeros(max_slots, dtype=np.int32)
        self.queue: List[Request] = []
        self._finished: List[Response] = []
        self._arrival: Dict[str, float] = {}
        self._ttft: List[Optional[float]] = [None] * max_slots
        # Device-call counters and decode wall time (host clock around
        # work that ends in a device sync), read through ``stats``.
        self.prefills = 0            # prefill forwards (chunks counted)
        self.decode_steps = 0
        self.decode_tokens = 0
        self.decode_s = 0.0
        self.verify_tokens = 0       # tokens emitted by verify steps
        self.verify_s = 0.0

    def _now(self) -> float:
        """A span stamp, on the tracer's clock (read at every call: tests
        swap the tracer after construction)."""
        return self._tracer.now()

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------

    def _init_cache(self):
        return init_kv_cache(self.cfg, self.max_slots, self.max_len,
                             self.device, quant=self.kv_quant,
                             n_kv_heads=local_kv_heads(self.cfg, self.layout))

    def _base_forward(self):
        """The cache forward before the weight-dequantising wrapper: the
        config's model family (Llama, or Mixtral's dropless MoE FFN)
        under the cache layout, on the engine's tp layout."""
        base = base_forward_for(self.cfg) or forward_with_cache
        if self.kv_quant == "int8":
            return make_quantized_forward(base, layout=self.layout)
        return functools.partial(base, layout=self.layout)

    def _prefill_forward(self, tokens: torch.Tensor, slot: int,
                         start: torch.Tensor, real_len: int,
                         logits_index: torch.Tensor) -> torch.Tensor:
        """The prefill's model call: one row, ``tokens`` [1, T] written at
        ``start`` into the slot's cache rows (a slot view of every cache
        leaf, whose slot axis is the second)."""
        view = tree_map(lambda t: t[:, slot:slot + 1], self.cache)
        logits, _ = self._forward(self.cfg, self.params, tokens, view, start,
                                  logits_index=logits_index)
        return logits

    def _decode_forward(self, tokens: torch.Tensor, lens: torch.Tensor,
                        mask: torch.Tensor,
                        token_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """The model call over every slot: a decode step (``tokens`` [B,
        1]) or a verify step ([B, gamma+1], with the real-token mask)."""
        logits, _ = self._forward(self.cfg, self.params, tokens, self.cache,
                                  lens, mask, token_mask=token_mask)
        return logits

    # The three device funnels: every model call of the engine goes
    # through one of them, from host arrays, and returns the logits.  A tp
    # group's followers replay exactly these (``serve/multihost.py``).

    @torch.no_grad()
    def _prefill_logits(self, padded: np.ndarray, slot: int, real_len: int,
                        start_pos: int = 0) -> torch.Tensor:
        """The prefill's logits [1, 1, V] at its last real token."""
        tokens = torch.from_numpy(padded).to(self.device, torch.long)[None]
        start = torch.full((1,), start_pos, dtype=torch.long,
                           device=self.device)
        idx = torch.tensor([real_len - 1], device=self.device)
        return self._prefill_forward(tokens, slot, start, real_len, idx)

    @torch.no_grad()
    def _decode_logits(self, last: np.ndarray, mask: np.ndarray
                       ) -> torch.Tensor:
        """A decode step's logits [B, 1, V] at ``self.lens``."""
        dev = self.device
        tokens = torch.from_numpy(last).to(dev, torch.long)[:, None]
        return self._decode_forward(tokens,
                                    torch.from_numpy(self.lens).to(dev),
                                    torch.from_numpy(mask).to(dev))

    @torch.no_grad()
    def _verify_logits(self, toks: np.ndarray, ntok: np.ndarray,
                       mask: np.ndarray) -> torch.Tensor:
        """A verify step's logits [B, gamma+1, V] at ``self.lens``: only
        each row's first ``ntok`` tokens are real and write K/V."""
        dev = self.device
        tokens = torch.from_numpy(toks).to(dev, torch.long)
        T = tokens.shape[1]
        mask_t = torch.from_numpy(mask).to(dev)
        ntok_t = torch.from_numpy(ntok).to(dev)
        token_mask = mask_t[:, None] * (
            torch.arange(T, device=dev)[None, :] < ntok_t[:, None]).float()
        return self._decode_forward(tokens,
                                    torch.from_numpy(self.lens).to(dev),
                                    mask_t, token_mask)

    @torch.no_grad()
    def _prefill(self, padded: np.ndarray, slot: int, real_len: int,
                 samp: np.ndarray, start_pos: int = 0) -> int:
        """Prefill ``real_len`` new tokens of one request into one slot at
        cache offset ``start_pos`` (past a prefix served from cache);
        returns its first generated token."""
        tr = self._tracer
        with tr.span(None, "prefill-enqueue"):
            logits = self._prefill_logits(padded, slot, real_len, start_pos)
            sample = self._sample if self._filters_on(samp) \
                else self._sample_plain
            samp_t = torch.from_numpy(samp).to(self.device)[None]
            noise = self._noise(logits[:, 0], samp[None])
            tok = sample(logits[:, 0], samp_t, noise)
        with tr.span(None, "prefill-sync"):
            tok = int(tok[0])
        self.prefills += 1
        return tok

    @torch.no_grad()
    def _decode_call(self, last: np.ndarray, temps: np.ndarray,
                     mask: np.ndarray) -> np.ndarray:
        """One decode step for every slot (inactive ones write nothing)."""
        t0 = time.perf_counter()
        dev = self.device
        tr = self._tracer
        with tr.span(None, "decode-enqueue", step=self.decode_steps + 1):
            logits = self._decode_logits(last, mask)
            sample = self._sample if self._filters_on(temps) \
                else self._sample_plain
            noise = self._noise(logits[:, 0], temps)
            toks = sample(logits[:, 0], torch.from_numpy(temps).to(dev),
                          noise)
        with tr.span(None, "decode-sync"):
            toks = toks.cpu().numpy()
        self.decode_steps += 1
        self.decode_tokens += int(mask.sum())
        self.decode_s += time.perf_counter() - t0
        return toks

    @torch.no_grad()
    def _verify_call(self, toks: np.ndarray, ntok: np.ndarray,
                     temps: np.ndarray, mask: np.ndarray):
        """Speculative verify: T = gamma+1 tokens (the last emitted one and
        the draft) for every slot in one forward.  Only each row's first
        ``ntok`` tokens are real and write K/V (in the paged pool a
        position past a slot's blocks would name another request's block).
        Returns (greedy [B, T]: the model's next token after each prefix,
        sampled0 [B]: position 0 sampled, for sampling slots)."""
        t0 = time.perf_counter()
        dev = self.device
        tr = self._tracer
        with tr.span(None, "verify-enqueue"):
            logits = self._verify_logits(toks, ntok, mask)
            greedy = logits.argmax(-1)
            sample = self._sample if self._filters_on(temps) \
                else self._sample_plain
            noise = self._noise(logits[:, 0], temps)
            sampled0 = sample(logits[:, 0], torch.from_numpy(temps).to(dev),
                              noise)
        with tr.span(None, "verify-sync"):
            greedy, sampled0 = greedy.cpu().numpy(), sampled0.cpu().numpy()
        self.spec_stats["verify_steps"] += 1
        self.verify_s += time.perf_counter() - t0
        return greedy, sampled0

    def _noise(self, logits: torch.Tensor, samp: np.ndarray):
        """Gumbel noise [B, V] for the rows that sample; None when every
        row is greedy (no draw)."""
        if not np.any(samp[:, 0] > 0):
            return None
        return _gumbel(logits.shape, self.generator, logits.device)

    @staticmethod
    def _filters_on(samp) -> bool:
        """Does this step need the filtered (sorting) sampler?"""
        s = np.asarray(samp)
        if s.ndim == 1:
            return bool(s[1] < 1.0 or s[2] > 0)
        return bool(np.any(s[:, 1] < 1.0) or np.any(s[:, 2] > 0))

    @staticmethod
    def _sample_plain(logits: torch.Tensor, samp: torch.Tensor,
                      noise: Optional[torch.Tensor]) -> torch.Tensor:
        """Greedy / plain-temperature sampling, batched.  logits: [B, V];
        samp: [B, 3] rows of [temperature, top_p, top_k]; noise: [B, V]
        Gumbel noise (or None when every row is greedy).  Sampling is the
        Gumbel-max trick, as ``jax.random.categorical`` draws."""
        greedy = logits.argmax(-1)
        if noise is None:
            return greedy
        temperature = samp[:, 0:1]
        scaled = logits / temperature.clamp(min=1e-6)
        sampled = (scaled + noise).argmax(-1)
        return torch.where(temperature[:, 0] <= 0.0, greedy, sampled)

    @staticmethod
    def _sample(logits: torch.Tensor, samp: torch.Tensor,
                noise: Optional[torch.Tensor]) -> torch.Tensor:
        """Greedy / temperature / top-p (nucleus) / top-k sampling, batched.
        temperature <= 0 is greedy regardless of the filters; top_p = 1 and
        top_k = 0 disable theirs.  Sorts the scaled logits once, masks
        tokens outside the nucleus / top-k, and samples in sorted space."""
        greedy = logits.argmax(-1)
        if noise is None:
            return greedy
        temperature, top_p, top_k = samp[:, 0:1], samp[:, 1:2], samp[:, 2:3]
        V = logits.shape[-1]
        scaled = logits / temperature.clamp(min=1e-6)
        sorted_l, sorted_idx = torch.sort(scaled, dim=-1, descending=True)
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Nucleus: keep tokens whose cumulative mass BEFORE them is
        # < top_p (the best token always survives).
        keep = (cum - probs) < top_p
        ranks = torch.arange(V, device=logits.device, dtype=torch.float32)
        keep &= torch.where(top_k > 0, ranks[None, :] < top_k, True)
        keep[:, 0] = True
        filt = sorted_l.masked_fill(~keep, float("-inf"))
        choice = (filt + noise).argmax(-1, keepdim=True)
        sampled = sorted_idx.gather(-1, choice)[:, 0]
        return torch.where(temperature[:, 0] <= 0.0, greedy, sampled)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def add_request(self, req: Request) -> None:
        self._arrival[req.request_id] = self._now()
        self._phase_mark(req.request_id, "queued")
        if len(req.prompt_tokens) >= self.max_len or req.max_new_tokens <= 0:
            self._cancel(req)
            return
        self.queue.append(req)

    def _cancel(self, req: Request) -> None:
        self._arrival.pop(req.request_id, None)
        self._req_phase_ts.pop(req.request_id, None)
        self._finished.append(Response(
            req.request_id, [], "cancelled",
            prompt_len=len(req.prompt_tokens), created=time.time()))

    # -- request-phase latency -------------------------------------------

    def _phase_mark(self, rid: str, phase: str) -> None:
        """Stamp a request's phase (queued, admitted) for the metrics and
        the spans; nothing when neither is on."""
        if self.metrics is None and not self._tracer.enabled:
            return
        self._req_phase_ts.setdefault(rid, {})[phase] = self._now()

    def _phase_observe(self, rid: str, terminal: bool = True) -> None:
        """Observe one request's queue and prefill phases at its first
        token (``terminal=False``), its decode phase at its finish."""
        if self.metrics is None and not self._tracer.enabled:
            return
        ts = self._req_phase_ts.get(rid)
        if ts is None:
            return
        now = self._now()
        if not terminal:
            if self.metrics is not None:
                if "queued" in ts and "admitted" in ts:
                    self.metrics.observe(
                        "tpu_serve_request_duration_seconds",
                        ts["admitted"] - ts["queued"], {"phase": "queue"})
                if "admitted" in ts:
                    self.metrics.observe(
                        "tpu_serve_request_duration_seconds",
                        now - ts["admitted"], {"phase": "prefill"})
            if "admitted" in ts:
                ts["first_token"] = now
            return
        if "first_token" in ts and self.metrics is not None:
            self.metrics.observe(
                "tpu_serve_request_duration_seconds",
                now - ts["first_token"], {"phase": "decode"})
        self._req_phase_ts.pop(rid, None)

    @property
    def num_active(self) -> int:
        return sum(1 for r in self.active if r is not None)

    @property
    def stats(self) -> Dict[str, Any]:
        """Scheduling state (the frontend's /stats and load headers) plus
        the device-call counters."""
        return {"queue_depth": len(self.queue),
                "active_slots": self.num_active,
                "prefills": self.prefills,
                "decode_steps": self.decode_steps,
                "decode_tokens": self.decode_tokens,
                "decode_s": self.decode_s,
                "verify_tokens": self.verify_tokens,
                "verify_s": self.verify_s}

    def has_work(self) -> bool:
        # _finished counts: instantly-cancelled requests must still be
        # drained by the driving loop or their callers would never wake.
        return (bool(self.queue) or self.num_active > 0
                or bool(self._finished) or self._inflight is not None)

    def step(self) -> List[Response]:
        """One engine iteration: admit (prefill) into every free slot until
        an admission is blocked (the paged engine waits for memory), then
        decode all active slots.  Returns finished responses.

        With ``prefill_chunk`` set, at most one chunk of prompt runs per
        step, even on the step where an admission's last chunk lands, and
        a decode pass runs in between."""
        tr = self._tracer
        with tr.span(None, "engine-step"):
            chunked_this_step = False
            if self._inflight is not None:
                with tr.span(None, "step-chunk"):
                    self._chunk_step()
                chunked_this_step = True
            while self.queue and self._inflight is None \
                    and not chunked_this_step:
                free = next((i for i, r in enumerate(self.active)
                             if r is None), None)
                if free is None:
                    break
                req = self.queue.pop(0)
                if self.prefill_chunk > 0:
                    with tr.span(None, "step-chunk"):
                        began = self._begin_chunked(req, free)
                    if began is None:
                        continue    # cancelled outright; the slot is free
                    break           # one chunk per step
                with tr.span(None, "step-admit"):
                    admitted = self._admit(req, free)
                if not admitted:
                    break           # blocked (the paged engine's memory)
            if self.num_active:
                with tr.span(None, "step-decode"):
                    self._decode_all()
        out, self._finished = self._finished, []
        return out

    def run(self, max_steps: int = 10_000) -> List[Response]:
        """Drain: run until all queued + active requests finish."""
        out: List[Response] = list(self._finished)   # e.g. cancelled on add
        self._finished = []
        for _ in range(max_steps):
            if not self.has_work():
                break
            out.extend(self.step())
        return out

    # ------------------------------------------------------------------

    @staticmethod
    def _samp(req: Request) -> np.ndarray:
        return np.array([req.temperature, req.top_p, float(req.top_k)],
                        np.float32)

    def _admit(self, req: Request, slot: int) -> bool:
        """Prefill a request into a free slot and return True.  The paged
        engine returns False when the admission is blocked on memory (the
        request goes back to the queue)."""
        self._phase_mark(req.request_id, "admitted")
        plen = len(req.prompt_tokens)
        bucket = _bucket(plen, self.max_len)
        padded = np.zeros(bucket, dtype=np.int64)
        padded[:plen] = req.prompt_tokens
        tok = self._prefill(padded, slot, plen, self._samp(req))
        # The slot's cache holds `bucket` rows; only plen are real, and
        # decode overwrites the padding rows from position plen on.
        self._finalize_admit(req, slot, tok)
        return True

    # -- chunked prefill ---------------------------------------------------

    def _begin_chunked(self, req: Request, slot: int):
        """Start a chunked admission.  Returns True when the first chunk
        ran, False when blocked (request requeued), None when the request
        was cancelled.  The paged engine reserves its blocks here."""
        self._phase_mark(req.request_id, "admitted")
        self._inflight = (req, slot, 0)
        self._chunk_step()
        return True

    def _chunk_step(self) -> None:
        """Prefill the next chunk of the in-flight admission; the last
        chunk's sample is the first generated token and activates the
        slot.  The offset is absolute into the prompt (a paged admission
        starts past its cached prefix).  Every chunk is padded to
        ``prefill_chunk`` and sampled at its last real token."""
        req, slot, off = self._inflight
        chunk = self.prefill_chunk
        toks = req.prompt_tokens[off:off + chunk]
        padded = np.zeros(chunk, dtype=np.int64)
        padded[:len(toks)] = toks
        tok = self._prefill(padded, slot, len(toks), self._samp(req),
                            start_pos=off)
        off += len(toks)
        if off >= len(req.prompt_tokens):
            self._inflight = None
            self._chunk_finalize(req, slot, tok)
        else:
            self._inflight = (req, slot, off)

    def _chunk_finalize(self, req: Request, slot: int, tok: int) -> None:
        self._finalize_admit(req, slot, tok)

    def _finalize_admit(self, req: Request, slot: int, tok: int) -> None:
        """Activate a prefilled slot: TTFT, phases, lengths, the first
        token."""
        self._phase_observe(req.request_id, terminal=False)
        ts = self._req_phase_ts.get(req.request_id) or {}
        arrival = self._arrival.pop(req.request_id, None)
        # The first-token stamp, where there is one, is the TTFT's instant
        # too, so the span tree and the observation agree (the exemplar is
        # stamped with wall time, as exposition wants).
        now = ts.get("first_token", self._now())
        ttft = (now - arrival) if arrival is not None else None
        self._ttft[slot] = ttft
        if self.metrics is not None and ttft is not None:
            self.metrics.observe(
                "tpu_serve_request_duration_seconds", ttft,
                {"phase": "ttft"}, buckets=SERVE_LATENCY_BUCKETS,
                exemplar=(req.trace.trace_id if req.trace is not None
                          else None))
        if req.trace is not None and arrival is not None:
            admitted = ts.get("admitted", arrival)
            self._tracer.record_span(req.trace, "engine-queue",
                                     arrival, admitted)
            self._tracer.record_span(req.trace, "prefill", admitted, now,
                                     prompt_len=len(req.prompt_tokens))
        self.lens[slot] = len(req.prompt_tokens)
        self.active[slot] = req
        self.generated[slot] = [tok]
        self.budget[slot] = req.max_new_tokens - 1
        self._spec_miss[slot] = 0
        self._spec_index[slot] = None      # a fresh history for the slot
        self._emit_tokens(req, [tok])
        self._maybe_finish(slot)

    def _emit_tokens(self, req: Request, tokens: List[int]) -> None:
        cb = self.token_callback
        if cb is not None and tokens:
            cb(req.request_id, tokens)

    def _decode_all(self):
        last = np.zeros(self.max_slots, dtype=np.int64)
        # Per-slot [temperature, top_p, top_k] rows; idle slots keep the
        # no-op defaults (greedy, filters off).
        temps = np.zeros((self.max_slots, 3), dtype=np.float32)
        temps[:, 1] = 1.0
        mask = np.zeros(self.max_slots, dtype=np.float32)
        for i, req in enumerate(self.active):
            if req is not None and self.generated[i]:
                last[i] = self.generated[i][-1]
                temps[i] = self._samp(req)
                mask[i] = 1.0
        if self.speculative > 0:
            drafts = self._build_drafts()
            drafting = sum(1 for d in drafts if d)
            if drafting and drafting >= max(1, self.num_active) * \
                    self.SPEC_MIN_DRAFT_FRACTION:
                with self._tracer.span(None, "step-verify"):
                    return self._spec_decode_all(last, temps, mask, drafts)
        toks = self._decode_call(last, temps, mask)
        with self._tracer.span(None, "decode-emit"):
            for i, req in enumerate(self.active):
                if req is None:
                    continue
                self.lens[i] += 1
                self.generated[i].append(int(toks[i]))
                self.budget[i] -= 1
                self._emit_tokens(req, [int(toks[i])])
                self._maybe_finish(i)

    # -- speculative decoding ----------------------------------------------

    def _build_drafts(self) -> List[List[int]]:
        """Per-slot prompt-lookup drafts.  Sampling slots never draft
        (greedy acceptance would bias their distribution); backed-off
        slots wait out their cooldown."""
        gamma = self.speculative
        drafts: List[List[int]] = [[] for _ in range(self.max_slots)]
        for i, req in enumerate(self.active):
            if req is None or req.temperature > 0 or not self.generated[i]:
                continue
            if self._spec_miss[i] >= self.SPEC_MISS_LIMIT:
                if self._spec_cooldown[i] > 0:
                    self._spec_cooldown[i] -= 1
                    continue
            # Positions lens..lens+gamma must stay below max_len (and, in
            # the paged engine, inside the slot's blocks).
            cap = min(gamma, self.max_len - int(self.lens[i]) - 2,
                      int(self.budget[i]), self._extra_draft_cap(i))
            if cap <= 0:
                continue
            hist = list(req.prompt_tokens) + self.generated[i]
            idx = self._spec_index[i]
            if idx is None:
                idx = self._spec_index[i] = NgramIndex()
            idx.extend(hist)
            drafts[i] = idx.draft(hist, cap)
        return drafts

    def _extra_draft_cap(self, slot: int) -> int:
        """The engine's own bound on a draft (paged: block capacity)."""
        return self.speculative

    def _spec_decode_all(self, last, temps, mask, drafts):
        gamma = self.speculative
        toks = np.zeros((self.max_slots, gamma + 1), dtype=np.int64)
        toks[:, 0] = last
        ntok = np.zeros(self.max_slots, dtype=np.int64)
        for i, d in enumerate(drafts):
            toks[i, 1:1 + len(d)] = d
            ntok[i] = (1 + len(d)) if mask[i] > 0 else 0
        greedy, sampled0 = self._verify_call(toks, ntok, temps, mask)
        with self._tracer.span(None, "verify-emit"):
            for i, req in enumerate(self.active):
                if req is None:
                    continue
                if req.temperature > 0:
                    emitted = [int(sampled0[i])]
                else:
                    # Longest-prefix acceptance: greedy[i, j] checks draft[j]
                    # and is the correction (or bonus) token where it stops.
                    emitted = []
                    for j in range(len(drafts[i]) + 1):
                        emitted.append(int(greedy[i, j]))
                        if j >= len(drafts[i]) or greedy[i, j] != drafts[i][j]:
                            break
                    self.spec_stats["drafted"] += len(drafts[i])
                    self.spec_stats["accepted"] += len(emitted) - 1
                    if drafts[i]:
                        if len(emitted) > 1:
                            self._spec_miss[i] = 0
                        else:
                            self._spec_miss[i] += 1
                            if self._spec_miss[i] >= self.SPEC_MISS_LIMIT:
                                self._spec_cooldown[i] = self.SPEC_PROBE_EVERY
                take: List[int] = []
                for t in emitted:
                    take.append(t)
                    self.budget[i] -= 1
                    if self.budget[i] <= 0 or self._is_stop(req, t) \
                            or self.lens[i] + len(take) + 1 >= self.max_len:
                        break
                self.lens[i] += len(take)
                self.generated[i].extend(take)
                self.verify_tokens += len(take)
                self._emit_tokens(req, take)
                self._maybe_finish(i)

    @staticmethod
    def _is_stop(req: Request, tok: int) -> bool:
        if req.eos_token is not None and tok == req.eos_token:
            return True
        return bool(req.stop_token_ids) and tok in req.stop_token_ids

    def _maybe_finish(self, slot: int):
        req = self.active[slot]
        if req is None:
            return
        gen = self.generated[slot]
        reason = None
        if gen and self._is_stop(req, gen[-1]):
            reason = "eos"
        elif self.budget[slot] <= 0:
            reason = "length"
        elif self.lens[slot] + 1 >= self.max_len:
            reason = "length"
        if reason:
            self._finish(slot, reason)

    def _finish(self, slot: int, reason: str) -> None:
        """The one finish path (length, eos or preemption); the paged
        engine hooks it to release the slot's blocks."""
        req = self.active[slot]
        ts = self._req_phase_ts.get(req.request_id) or {}
        now = self._now()
        if req.trace is not None and "first_token" in ts:
            self._tracer.record_span(
                req.trace, "decode", ts["first_token"], now,
                tokens=len(self.generated[slot]), reason=reason)
        self._phase_observe(req.request_id)
        self._finished.append(Response(
            req.request_id, list(self.generated[slot]), reason,
            prompt_len=len(req.prompt_tokens), created=time.time(),
            ttft_s=self._ttft[slot]))
        self.active[slot] = None
        self.generated[slot] = []
        self.lens[slot] = 0
        self._ttft[slot] = None
