"""Continuous-batching inference engine, in PyTorch.

Port of the core of ``kuberay_tpu/serve/engine.py::ServeEngine``: a fixed
slot count over a static dense KV cache; new requests prefill into free
slots while the others keep decoding; prompt lengths are bucketed to
powers of two; greedy, temperature, top-p and top-k sampling per request;
eos and stop tokens; TTFT per request.  The host loop does bookkeeping
only; every step runs ``serve/kv_cache.py::forward_with_cache`` on the
engine's device.

Where the JAX prefill runs every slot's row (one of them real) and computes
logits at every position, this one prefills only the target slot and takes
logits at its last real token: the other rows were write-masked anyway, so
the slot's result is the same, and at Llama-3-8B width it avoids gigabytes
of float32 logits.

Random draws use a ``torch.Generator`` on the engine's device, so sampled
(temperature > 0) tokens differ from the JAX engine's; greedy tokens do
not depend on the generator.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from kuberay_tpu_torch.models.llama import LlamaConfig
from kuberay_tpu_torch.serve.kv_cache import forward_with_cache, init_kv_cache
from kuberay_tpu_torch.utils.device import resolve_device


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


@dataclasses.dataclass
class Response:
    request_id: str
    tokens: List[int]                 # generated tokens (no prompt)
    finish_reason: str = "length"     # length|eos|cancelled
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


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


class ServeEngine:
    def __init__(self, cfg: LlamaConfig, params: Dict[str, Any],
                 max_slots: int = 8, max_len: int = 2048,
                 rng_seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        if max_len > cfg.max_seq_len:
            raise ValueError(f"max_len {max_len} exceeds the model's "
                             f"max_seq_len {cfg.max_seq_len}")
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.cache = init_kv_cache(cfg, max_slots, max_len, self.device)
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
        self.prefills = 0
        self.decode_steps = 0
        self.decode_tokens = 0
        self.decode_s = 0.0

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _prefill(self, padded: np.ndarray, slot: int, real_len: int,
                 samp: np.ndarray) -> int:
        """Prefill one request into one slot; returns its first token."""
        tokens = torch.from_numpy(padded).to(self.device, torch.long)[None]
        view = {k: v[:, slot:slot + 1] for k, v in self.cache.items()}
        start = torch.zeros(1, dtype=torch.long, device=self.device)
        idx = torch.tensor([real_len - 1], device=self.device)
        logits, _ = forward_with_cache(self.cfg, self.params, tokens, view,
                                       start, logits_index=idx)
        sample = self._sample if self._filters_on(samp) else self._sample_plain
        samp_t = torch.from_numpy(samp).to(self.device)[None]
        noise = self._noise(logits[:, 0], samp[None])
        self.prefills += 1
        return int(sample(logits[:, 0], samp_t, noise)[0])

    @torch.no_grad()
    def _decode_call(self, last: np.ndarray, temps: np.ndarray,
                     mask: np.ndarray) -> np.ndarray:
        """One decode step for every slot (inactive ones write nothing)."""
        t0 = time.perf_counter()
        dev = self.device
        tokens = torch.from_numpy(last).to(dev, torch.long)[:, None]
        logits, _ = forward_with_cache(
            self.cfg, self.params, tokens, self.cache,
            torch.from_numpy(self.lens).to(dev),
            torch.from_numpy(mask).to(dev))
        sample = self._sample if self._filters_on(temps) else self._sample_plain
        noise = self._noise(logits[:, 0], temps)
        toks = sample(logits[:, 0], torch.from_numpy(temps).to(dev), noise)
        toks = toks.cpu().numpy()
        self.decode_steps += 1
        self.decode_tokens += int(mask.sum())
        self.decode_s += time.perf_counter() - t0
        return toks

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
        self._arrival[req.request_id] = time.time()
        if len(req.prompt_tokens) >= self.max_len or req.max_new_tokens <= 0:
            self._cancel(req)
            return
        self.queue.append(req)

    def _cancel(self, req: Request) -> None:
        self._arrival.pop(req.request_id, None)
        self._finished.append(Response(
            req.request_id, [], "cancelled",
            prompt_len=len(req.prompt_tokens), created=time.time()))

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
                "decode_s": self.decode_s}

    def has_work(self) -> bool:
        # _finished counts: instantly-cancelled requests must still be
        # drained by the driving loop or their callers would never wake.
        return (bool(self.queue) or self.num_active > 0
                or bool(self._finished))

    def step(self) -> List[Response]:
        """One engine iteration: admit (prefill) into every free slot, then
        decode all active slots.  Returns finished responses."""
        while self.queue:
            free = next((i for i, r in enumerate(self.active) if r is None),
                        None)
            if free is None:
                break
            self._admit(self.queue.pop(0), free)
        if self.num_active:
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

    def _admit(self, req: Request, slot: int) -> None:
        plen = len(req.prompt_tokens)
        bucket = _bucket(plen, self.max_len)
        padded = np.zeros(bucket, dtype=np.int64)
        padded[:plen] = req.prompt_tokens
        tok = self._prefill(padded, slot, plen, self._samp(req))
        # The slot's cache holds `bucket` rows; only plen are real, and
        # decode overwrites the padding rows from position plen on.
        arrival = self._arrival.pop(req.request_id, None)
        self._ttft[slot] = (time.time() - arrival) if arrival is not None \
            else None
        self.lens[slot] = plen
        self.active[slot] = req
        self.generated[slot] = [tok]
        self.budget[slot] = req.max_new_tokens - 1
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
        toks = self._decode_call(last, temps, mask)
        for i, req in enumerate(self.active):
            if req is None:
                continue
            self.lens[i] += 1
            self.generated[i].append(int(toks[i]))
            self.budget[i] -= 1
            self._emit_tokens(req, [int(toks[i])])
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
        req = self.active[slot]
        self._finished.append(Response(
            req.request_id, list(self.generated[slot]), reason,
            prompt_len=len(req.prompt_tokens), created=time.time(),
            ttft_s=self._ttft[slot]))
        self.active[slot] = None
        self.generated[slot] = []
        self.lens[slot] = 0
        self._ttft[slot] = None
