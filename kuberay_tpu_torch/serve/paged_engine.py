"""Continuous batching over a paged KV cache with prefix reuse, in PyTorch.

Port of the core of ``kuberay_tpu/serve/paged_engine.py``: a shared
physical block pool (``serve/paged_kv.py``) replaces the per-slot
``max_len`` cache rows, so device memory is sized by live tokens, and
block-aligned prompt prefixes are shared across requests (system prompts
and few-shot preambles prefill once).  The pool is bf16 or, with
``kv_quant="int8"``, int8 with per-position scales.

Scheduling, as in the JAX engine:
- admission also needs free blocks for the prompt plus the first decoded
  token; otherwise the request waits at the head of the queue;
- a decode step that crosses a block boundary appends a block to the
  slot's table; when the pool is exhausted the request finishes with
  ``finish_reason="preempted"`` (a resubmission finds its prefix cached);
- on finish the request's blocks are released; full prompt blocks stay
  published in the prefix cache until cannibalised.

Chunked prefill reserves every block of the prompt up front and starts
past the prefix the cache serves.  Speculation grows each drafting slot's
blocks for its draft best-effort, after every slot's mandatory next-token
block, and caps a draft at the blocks the slot holds: a position past
them would resolve through the zero-filled tail of its table into block
0, another request's block, so only real tokens write.  Weight
quantisation dequantises outermost, around the paged forward.

Not ported yet: KV tiers, KV-block export/import and adverts, tensor
parallelism and Mixtral.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from kuberay_tpu_torch.models.llama import LlamaConfig
from kuberay_tpu_torch.serve.engine import Request, ServeEngine, _bucket
from kuberay_tpu_torch.serve.paged_kv import (
    BlockAllocator,
    init_paged_cache,
    make_paged_forward,
    make_paged_quant_forward,
)


class PagedServeEngine(ServeEngine):
    def __init__(self, cfg: LlamaConfig, params: Dict[str, Any],
                 max_slots: int = 8, max_len: int = 2048,
                 num_blocks: int = 0, block_size: int = 16,
                 rng_seed: int = 0, device="cuda", kv_quant: str = "none",
                 prefill_chunk: int = 0, speculative: int = 0,
                 weight_quant: str = "none", donate_params: bool = False,
                 metrics=None, tracer=None):
        # Default pool = the dense engine's footprint; callers shrink it
        # to realise the memory gain (e.g. slots * expected length).
        num_blocks = num_blocks or (max_slots * max_len) // block_size
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.max_blocks = (max_len + block_size - 1) // block_size
        # The base constructor builds the pool through _init_cache and the
        # forward through _base_forward (wrapped by the weight dequant).
        super().__init__(cfg, params, max_slots=max_slots, max_len=max_len,
                         rng_seed=rng_seed, device=device, kv_quant=kv_quant,
                         prefill_chunk=prefill_chunk, speculative=speculative,
                         weight_quant=weight_quant,
                         donate_params=donate_params, metrics=metrics,
                         tracer=tracer)
        self.allocator = BlockAllocator(num_blocks, block_size)
        self.tables = np.zeros((max_slots, self.max_blocks), dtype=np.int32)
        self.owned: List[List[int]] = [[] for _ in range(max_slots)]
        self._wait_state = None        # (request id, num_free) at last block

    def _init_cache(self):
        return init_paged_cache(self.cfg, self.num_blocks, self.block_size,
                                quant=self.kv_quant, device=self.device)

    def _base_forward(self):
        return (make_paged_quant_forward if self.kv_quant == "int8"
                else make_paged_forward)(self.block_size)

    # ------------------------------------------------------------------
    # model calls (paged signatures)
    # ------------------------------------------------------------------

    def _prefill_forward(self, tokens, slot, start, real_len, logits_index):
        """One row with the slot's own table: the pool is shared, so the
        call writes the slot's real tokens through its table (never a
        slice of the pool), from ``start`` (past a cached prefix) on."""
        T = tokens.shape[1]
        dev = self.device
        tables = torch.from_numpy(self.tables[slot:slot + 1]).to(dev)
        token_mask = (torch.arange(T, device=dev) < real_len)[None].float()
        logits, _ = self._forward(
            self.cfg, self.params, tokens, self.cache, tables, start,
            torch.ones(1, device=dev), token_mask=token_mask,
            logits_index=logits_index)
        return logits

    def _decode_forward(self, tokens, lens, mask, token_mask=None):
        """Decode or verify over every slot's table; the token mask gates
        the pool's writes (a decode step's is the slot mask)."""
        logits, _ = self._forward(
            self.cfg, self.params, tokens, self.cache,
            torch.from_numpy(self.tables).to(self.device), lens, mask,
            token_mask=mask[:, None] if token_mask is None else token_mask)
        return logits

    def _extra_draft_cap(self, slot: int) -> int:
        """Drafts only reach into allocated blocks: positions lens ..
        lens+cap stay below the slot's capacity (``_decode_all`` grows it
        best-effort first; a full pool shrinks the draft)."""
        capacity = len(self.owned[slot]) * self.block_size
        return capacity - int(self.lens[slot]) - 1

    # ------------------------------------------------------------------
    # block bookkeeping
    # ------------------------------------------------------------------

    def _blocks_needed(self, n_tokens: int) -> int:
        return (n_tokens + self.block_size - 1) // self.block_size

    def _grow(self, slot: int, n_blocks: int) -> bool:
        """Append n fresh blocks to a slot's table; all-or-nothing."""
        got: List[int] = []
        for _ in range(n_blocks):
            bid = self.allocator.allocate()
            if bid is None:
                for b in got:
                    self.allocator.free(b)
                return False
            got.append(bid)
        base = len(self.owned[slot])
        self.owned[slot].extend(got)
        self.tables[slot, base:base + len(got)] = got
        return True

    def _release(self, slot: int):
        for bid in self.owned[slot]:
            self.allocator.free(bid)
        self.owned[slot] = []
        self.tables[slot] = 0

    def _shrink_headroom(self, slot: int) -> None:
        """Return unwritten draft-headroom blocks (past what lens+1 needs)
        to the pool.  Tail blocks are always the slot's own (shared prefix
        blocks sit at the front) and K/V past ``lens`` is dead."""
        keep = self._blocks_needed(int(self.lens[slot]) + 1)
        while len(self.owned[slot]) > keep:
            bid = self.owned[slot].pop()
            self.tables[slot, len(self.owned[slot])] = 0
            self.allocator.free(bid)

    # ------------------------------------------------------------------
    # scheduling overrides
    # ------------------------------------------------------------------

    def _reserve(self, req: Request, slot: int):
        """Memory admission: prefix match plus reservation of every block
        for the prompt AND the first decoded token.  Returns the number of
        tokens served from cache (int), False when blocked on memory
        (request requeued at the head), or None when the prompt can never
        fit (request cancelled)."""
        plen = len(req.prompt_tokens)
        # A prompt the pool can never hold is rejected, not retried:
        # requeueing it would block everything behind it for good.
        if self._blocks_needed(plen + 1) > self.num_blocks:
            self._cancel(req)
            return None
        # While blocked on memory nothing changes until a block is freed:
        # skip the O(plen) prefix re-match until num_free moves.
        if self._wait_state == (id(req), self.allocator.num_free):
            self.queue.insert(0, req)
            return False
        # Longest cached block-aligned prefix — but at least one token
        # must run through prefill to produce logits.
        cached = self.allocator.match_prefix(req.prompt_tokens)
        while cached and len(cached) * self.block_size >= plen:
            self.allocator.free(cached.pop())
        # Allocate the headroom for the first decoded token now, so that
        # admissions of one step() do not consume each other's spare.
        need = self._blocks_needed(plen + 1) - len(cached)
        if self.allocator.num_free < need:
            for b in cached:
                self.allocator.free(b)
            self._wait_state = (id(req), self.allocator.num_free)
            self.queue.insert(0, req)       # wait for memory, keep order
            return False
        self._wait_state = None
        self.owned[slot] = list(cached)
        self.tables[slot, :len(cached)] = cached
        ok = self._grow(slot, need)
        assert ok, "free-count check guaranteed allocation"
        self.allocator.count_prefix_stats(plen, len(cached))
        return len(cached) * self.block_size

    def _register_full_prompt(self, req: Request, slot: int) -> None:
        """Publish the prompt's full blocks for later requests (cached
        blocks re-register as no-ops).  Bucket padding past the prompt is
        never written (the per-token write gate), so shared content is
        exactly the real tokens."""
        plen = len(req.prompt_tokens)
        self.allocator.register_prefix(
            req.prompt_tokens[:plen - plen % self.block_size],
            self.owned[slot])

    def _admit(self, req: Request, slot: int) -> bool:
        a0 = self._now()
        reserved = self._reserve(req, slot)
        if reserved is None:
            return True                     # cancelled; slot stays free
        if reserved is False:
            return False                    # blocked on memory
        ncached = reserved
        self._phase_mark(req.request_id, "admitted")
        self._kv_alloc_span(req, slot, a0, ncached)
        plen = len(req.prompt_tokens)
        new_tokens = plen - ncached
        bucket = _bucket(new_tokens, self.max_len)
        padded = np.zeros(bucket, dtype=np.int64)
        padded[:new_tokens] = req.prompt_tokens[ncached:]
        tok = self._prefill(padded, slot, new_tokens, self._samp(req),
                            start_pos=ncached)
        self._register_full_prompt(req, slot)
        self._finalize_admit(req, slot, tok)
        return True

    def _kv_alloc_span(self, req: Request, slot: int, a0: float,
                       ncached: int) -> None:
        if req.trace is not None:
            self._tracer.record_span(
                req.trace, "kv-alloc", a0, self._now(),
                cached_tokens=ncached, blocks=len(self.owned[slot]))

    # -- chunked prefill over the block tables -------------------------------

    def _begin_chunked(self, req: Request, slot: int):
        a0 = self._now()
        reserved = self._reserve(req, slot)
        if reserved is None or reserved is False:
            return reserved                 # cancelled / blocked on memory
        self._phase_mark(req.request_id, "admitted")
        self._kv_alloc_span(req, slot, a0, reserved)
        # Every block is reserved; start past the cache-served prefix.
        self._inflight = (req, slot, reserved)
        self._chunk_step()
        return True

    def _chunk_finalize(self, req: Request, slot: int, tok: int) -> None:
        self._register_full_prompt(req, slot)
        self._finalize_admit(req, slot, tok)

    def _decode_all(self):
        # Pass 1: the mandatory next-token block of every slot whose next
        # write crosses a block boundary; preempt (finish early) when the
        # pool is exhausted.  Draft headroom must never starve another
        # slot's mandatory block.
        for i, req in enumerate(self.active):
            if req is None:
                continue
            if self.lens[i] >= len(self.owned[i]) * self.block_size:
                if not self._grow(i, 1):
                    self._finish(i, "preempted")
        # Pass 2: best-effort draft headroom for draft-eligible slots; a
        # slot that cannot draft (sampling, backed off) gives its idle
        # headroom back.
        for i, req in enumerate(self.active):
            if req is None or self.speculative <= 0:
                continue
            if req.temperature > 0 or \
                    self._spec_miss[i] >= self.SPEC_MISS_LIMIT:
                self._shrink_headroom(i)
                continue
            want = int(self.lens[i]) + 1 + self.speculative
            while len(self.owned[i]) * self.block_size < want:
                if not self._grow(i, 1):
                    break
        if self.num_active:
            super()._decode_all()

    def _finish(self, slot: int, reason: str) -> None:
        super()._finish(slot, reason)
        self._release(slot)

    @property
    def stats(self) -> Dict[str, Any]:
        a = self.allocator
        return {**super().stats,
                "num_blocks": a.num_blocks,
                "free_blocks": a.num_free,
                "prefix_hit_tokens": a.prefix_hits,
                "prefix_query_tokens": a.prefix_queries}
