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

KV tiers (``host_blocks`` / ``spill_blocks`` > 0, ``serve/kv_tiers.py``):
a prompt block whose last reference drops is queued for demotion, and the
step after it copies at most 4 such blocks device-to-host (float32, the
wire layout), each looked up in the allocator at copy time so an evicted or
re-registered block never demotes stale bytes under a hash.  Admission
first promotes the tier-resident run that extends the device-resident
prefix back into the pool, so the prefix match serves it.  Both copies run
on the engine-loop thread, between steps, on the current stream: a
promoted row lands before the next step's kernels read it.

KV-block transfer (disaggregated prefill and decode): ``resident_prefix_
blocks`` probes how much of a prompt a replica holds, ``export_kv_blocks``
reads a prompt's registered blocks out of the pool (or their tier copies
once the pool evicted them) as float32 ``[L, Hkv, block_size, D]``
little-endian base64 records, byte for byte the JAX engine's, and
``import_kv_blocks`` adopts them refcount-0 cached, stopping clean at a
chain gap, a malformed payload or a full pool.  Callers serialise these
with ``step()`` (``ServeFrontend.call_engine``).

Mixtral configs run ``forward_with_cache_mixtral`` (the dropless MoE FFN)
as the paged forward's base; prefix sharing stays on, since a dropless
token's experts depend on its own hidden state only.

Chunked prefill reserves every block of the prompt up front and starts
past the prefix the cache serves.  Speculation grows each drafting slot's
blocks for its draft best-effort, after every slot's mandatory next-token
block, and caps a draft at the blocks the slot holds: a position past
them would resolve through the zero-filled tail of its table into block
0, another request's block, so only real tokens write.  Weight
quantisation dequantises outermost, around the paged forward.

A decode step replays one CUDA graph of the decode forward, and a prefill
from cache position 0 one graph of the prefill forward a prompt bucket
(``serve/forward_graphs.py``), on a CUDA device over a bf16 pool, in one
process, with the dense FFN and unquantised weights; other engines, every
verify step and every prefill past a cached prefix run the forward
eagerly.

Tensor parallelism (``layout``, as the dense engine's): the pool holds the
rank's kv heads and the tables ride every step plan to the followers
(``serve/multihost.py::MultihostPagedServeEngine``).  Every block read and
write goes through ``_read_blocks`` / ``_write_blocks``; under tp > 1 rank
0's engine turns them into block plans, so that each rank copies its kv
heads of the blocks and rank 0 gathers or scatters the heads over the
group.  Rank 0 alone holds the tier store and decides; the payloads and
the wire bytes are those of one process.
"""

from __future__ import annotations

import base64
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from kuberay_tpu_torch.models.llama import LlamaConfig
from kuberay_tpu_torch.serve import forward_graphs
from kuberay_tpu_torch.serve.engine import Request, ServeEngine, _bucket
from kuberay_tpu_torch.serve.kv_cache import base_forward_for
from kuberay_tpu_torch.serve.kv_tiers import KvTierStore
from kuberay_tpu_torch.serve.paged_kv import (
    BlockAllocator,
    init_paged_cache,
    make_paged_forward,
    make_paged_quant_forward,
)
from kuberay_tpu_torch.serve.sharding import local_kv_heads

# The KV-block wire payload's element type: float32, little-endian.
WIRE_DTYPE = np.dtype("<f4")


class PagedServeEngine(ServeEngine):
    def __init__(self, cfg: LlamaConfig, params: Dict[str, Any],
                 max_slots: int = 8, max_len: int = 2048,
                 num_blocks: int = 0, block_size: int = 16,
                 rng_seed: int = 0, device="cuda", kv_quant: str = "none",
                 prefill_chunk: int = 0, speculative: int = 0,
                 weight_quant: str = "none", donate_params: bool = False,
                 metrics=None, tracer=None, host_blocks: int = 0,
                 spill_blocks: int = 0, layout=None):
        if (host_blocks > 0 or spill_blocks > 0) and kv_quant != "none":
            raise ValueError(
                "KV tiering requires kv_quant='none' (tier payloads "
                "ride the float32 export wire format)")
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
                         tracer=tracer, layout=layout)
        self.allocator = BlockAllocator(num_blocks, block_size)
        # The forwards' CUDA graphs, where these settings allow them.
        self._graph: Optional[forward_graphs.ForwardGraphs] = None
        if forward_graphs.eligible(self.device, kv_quant, weight_quant,
                                   layout, cfg):
            self._graph = forward_graphs.ForwardGraphs(self.device)
        self.tables = np.zeros((max_slots, self.max_blocks), dtype=np.int32)
        self.owned: List[List[int]] = [[] for _ in range(max_slots)]
        self._wait_state = None        # (request id, num_free) at last block
        # Optional host/spill tiers behind the device pool: freed blocks
        # demote in the step pump, admissions promote tier-resident
        # prefix blocks back instead of recomputing them.
        self.tiers: Optional[KvTierStore] = None
        self.tier_fetch_blocks = 0
        self.tier_demoted_blocks = 0
        if host_blocks > 0 or spill_blocks > 0:
            self.tiers = KvTierStore(host_blocks, spill_blocks,
                                     metrics=metrics)
            self.allocator.on_register = self._on_device_register
            self.allocator.on_evict = self._on_device_evict

    def _init_cache(self):
        return init_paged_cache(self.cfg, self.num_blocks, self.block_size,
                                quant=self.kv_quant, device=self.device,
                                n_kv_heads=local_kv_heads(self.cfg,
                                                          self.layout))

    def _base_forward(self):
        make = make_paged_quant_forward if self.kv_quant == "int8" \
            else make_paged_forward
        return make(self.block_size, base_forward_for(self.cfg),
                    layout=self.layout)

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

    def _graph_prefill(self, tokens, table, n):
        """The prefill forward from cache position 0 over device inputs (a
        graph's): ``tokens`` [1, T], the slot's ``table`` [1, max_blocks]
        and the real length ``n`` [1].  The token mask and the logits'
        index come from ``n`` on the device, and the prefix length, 0,
        reaches the forward from the host."""
        T = tokens.shape[1]
        dev = tokens.device
        logits, _ = self._forward(
            self.cfg, self.params, tokens, self.cache, table,
            torch.zeros(1, dtype=torch.long, device=dev),
            torch.ones(1, device=dev),
            token_mask=(torch.arange(T, device=dev) < n)[None].float(),
            logits_index=n - 1, prefix_len=0)
        return logits

    def _decode_forward(self, tokens, lens, mask, token_mask=None):
        """Decode or verify over every slot's table; the token mask gates
        the pool's writes (a decode step's is the slot mask)."""
        return self._pool_forward(
            tokens, lens, mask, torch.from_numpy(self.tables).to(self.device),
            token_mask)

    def _pool_forward(self, tokens, lens, mask, tables, token_mask=None):
        """The model call over every slot, with the tables on the device."""
        logits, _ = self._forward(
            self.cfg, self.params, tokens, self.cache, tables, lens, mask,
            token_mask=mask[:, None] if token_mask is None else token_mask)
        return logits

    @torch.no_grad()
    def _prefill_logits(self, padded, slot, real_len, start_pos=0):
        """A prefill's logits: from cache position 0, one replay of its
        bucket's CUDA graph (``serve/forward_graphs.py``) where the engine
        has graphs, else (past a cached prefix, whose length the live
        forward reads on the host) the eager forward."""
        if self._graph is None or start_pos:
            return super()._prefill_logits(padded, slot, real_len, start_pos)
        logits, captured = self._graph.replay(
            self._graph_prefill, (self.params, self.cache), padded[None],
            self.tables[slot:slot + 1], np.array([real_len], np.int64))
        self.prefill_graph_captures += captured
        self.prefill_graph_steps += 1
        return logits

    @torch.no_grad()
    def _decode_logits(self, last, mask):
        """A decode step's logits: one replay of the step's CUDA graph
        (``serve/forward_graphs.py``) where the engine has graphs, else the
        eager forward."""
        if self._graph is None:
            return super()._decode_logits(last, mask)
        logits, captured = self._graph.replay(
            self._pool_forward, (self.params, self.cache),
            last.reshape(-1, 1), self.lens, mask, self.tables)
        self.decode_graph_captures += captured
        self.decode_graph_steps += 1
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
            if self.tiers is not None and self.allocator.refcount[bid] == 0:
                h = self.allocator.hash_of(bid)
                if h is not None:
                    # Last reference dropped: queue the (still resident)
                    # block for the step pump's device-to-host copy.
                    self.tiers.note_freed(h)
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
    # tier hierarchy (device -> host -> spill; serve/kv_tiers.py)
    # ------------------------------------------------------------------

    def _on_device_register(self, h: int) -> None:
        self.tiers.note_device(h, True)

    def _on_device_evict(self, h: int) -> None:
        # The pool block is cannibalised: the hash leaves the device tier;
        # host and spill copies (where the pump made one) survive.
        self.tiers.note_device(h, False)

    def _block_rows(self, bids: Sequence[int]) -> torch.Tensor:
        """Pool positions of the given blocks, in order, on the device."""
        bs = self.block_size
        idx = np.concatenate([np.arange(b * bs, (b + 1) * bs) for b in bids])
        return torch.from_numpy(idx).to(self.device)

    def _read_local(self, bids: Sequence[int]) -> torch.Tensor:
        """This rank's pool rows of ``bids``: float32 ``[2, L, Hkv_local,
        n * block_size, D]`` (K then V) on the host; one gather per pool,
        the cast on the device, one device-to-host copy (a sync)."""
        idx = self._block_rows(bids)
        kv = torch.stack([self.cache[n][:, :, idx, :] for n in ("k", "v")])
        return kv.to(torch.float32).cpu()

    def _write_local(self, bids: Sequence[int], kv: torch.Tensor) -> None:
        """Write float32 ``[2, L, Hkv_local, n * block_size, D]`` into this
        rank's pool rows of ``bids``, cast to the pool's dtype, in place on
        the current stream (so before the next step's kernels read
        them)."""
        idx = self._block_rows(bids)
        for n, rows in zip(("k", "v"), kv):
            pool = self.cache[n]
            pool[:, :, idx, :] = rows.to(pool.device, pool.dtype)

    def _read_blocks(self, bids: Sequence[int]):
        """The rows of ``bids`` as float32 numpy ``[L, Hkv, n *
        block_size, D]`` K and V over every kv head (under tp > 1, rank
        0's engine gathers them from the group)."""
        kv = self._read_local(bids).numpy()
        return kv[0], kv[1]

    def _write_blocks(self, bids: Sequence[int], k: np.ndarray,
                      v: np.ndarray) -> None:
        """Write float32 ``[L, Hkv, n * block_size, D]`` K and V over every
        kv head into the rows of ``bids`` (under tp > 1, rank 0's engine
        scatters each rank its heads)."""
        self._write_local(bids, torch.from_numpy(np.stack([k, v])))

    def step(self):
        out = super().step()
        if self.tiers is not None:
            self._pump_demotions()
        return out

    def _pump_demotions(self, limit: int = 4) -> int:
        """Copy up to ``limit`` freed blocks device-to-host per step.

        Bounded so demotion never stalls the decode loop for long; a block
        evicted from the pool before its turn is lost to the hierarchy
        (the next miss recomputes it).  Each block is looked up in the
        allocator when its copy is made, so a racing eviction or
        re-registration never demotes stale bytes under a hash.  Returns
        the blocks taken off the pending queue."""
        picks = []                                   # (hash, block id, toks)
        done = 0
        while done < limit:
            h = self.tiers.pop_pending()
            if h is None:
                break
            entry = self.allocator.lookup_block(h)
            if entry is not None:                    # else evicted first
                picks.append((h, entry[0], entry[1]))
            done += 1
        if not picks:
            return done
        k, v = self._read_blocks([bid for _, bid, _ in picks])
        bs = self.block_size
        for j, (h, _, toks) in enumerate(picks):
            sl = slice(j * bs, (j + 1) * bs)
            if self.tiers.admit(h, toks, (k[:, :, sl, :].copy(),
                                          v[:, :, sl, :].copy())):
                self.tier_demoted_blocks += 1
                if self.metrics is not None:
                    self.metrics.inc("tpu_kv_tier_demotions_total",
                                     {"src": "device", "dst": "host"})
        return done

    def _promote_from_tiers(self, req: Request) -> int:
        """Import the tier-resident run extending the device-resident
        prefix back into the pool, so admission's match_prefix serves it
        without recompute.  Records a ``tier-fetch`` span on the request's
        trace when any block moved."""
        tokens = req.prompt_tokens
        bs = self.block_size
        t0 = self._now()
        resident = self.allocator.resident_prefix_blocks(tokens)
        hashes = self.allocator.block_hashes(tokens)
        promoted: List[tuple] = []          # (block id, (k, v))
        for i in range(resident, len(hashes)):
            toks = tuple(tokens[i * bs:(i + 1) * bs])
            payload = self.tiers.checkout(hashes[i], toks)
            if payload is None:
                break
            bid = self.allocator.import_block(hashes[i], toks)
            if bid is None:
                break                       # resident after all / pool full
            promoted.append((bid, payload))
        if not promoted:
            return 0
        self._write_blocks([bid for bid, _ in promoted],
                           np.concatenate([p[0] for _, p in promoted], 2),
                           np.concatenate([p[1] for _, p in promoted], 2))
        for bid, _ in promoted:
            self.allocator.free(bid)        # refcount-0 cached, like import
        self.tier_fetch_blocks += len(promoted)
        if self.metrics is not None:
            self.metrics.inc("tpu_kv_tier_promotions_total",
                             {"src": "host"}, value=len(promoted))
        if req.trace is not None:
            self._tracer.record_span(req.trace, "tier-fetch", t0,
                                     self._now(), blocks=len(promoted))
        return len(promoted)

    def kv_advert(self, since: int = 0) -> Dict[str, Any]:
        """Residency advert for the gateway's fleet index (an empty one
        without tiers)."""
        if self.tiers is None:
            return {"seq": 0, "reset": False, "add": [], "del": []}
        return self.tiers.advert_since(int(since))

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
        # Tier promotion first: blocks demoted to host or spill come back
        # into the pool, so the match below serves them from cache.
        if self.tiers is not None:
            self._promote_from_tiers(req)
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

    # ------------------------------------------------------------------
    # KV-block transfer (disaggregated prefill and decode)
    # ------------------------------------------------------------------
    #
    # A prefill replica exports the registered prefix blocks of a prompt;
    # a decode replica imports them into its own allocator and pool, after
    # which its admission (_reserve -> match_prefix) serves the prompt from
    # cache and only the partial tail block runs through prefill.  Blocks
    # are keyed by the chained block hashes the gateway's prefix index
    # shadows, so a transfer is content-addressed and delta-only.  Not
    # safe against a running engine loop: call through
    # ServeFrontend.call_engine.

    def resident_prefix_blocks(self, prompt_tokens: Sequence[int]) -> int:
        """Delta probe: longest cached block-aligned prefix (blocks)."""
        return self.allocator.resident_prefix_blocks(prompt_tokens)

    @staticmethod
    def _encode(a: np.ndarray) -> str:
        return base64.b64encode(a.astype(WIRE_DTYPE).tobytes()).decode()

    def export_kv_blocks(self, prompt_tokens: Sequence[int],
                         skip_blocks: int = 0,
                         max_blocks: int = 0) -> List[Dict[str, Any]]:
        """The registered prefix blocks of ``prompt_tokens``, past the
        first ``skip_blocks`` (resident on the importer), as wire records
        ``{index, hash, k, v}`` with float32 base64 payloads of shape [L,
        Hkv, block_size, D].  Stops at the first block this replica holds
        in no tier (a block the pool evicted is served from its host or
        spill copy when tiers are on); ``max_blocks`` > 0 caps the record
        count, so the importer still holds a contiguous prefix."""
        if self.kv_quant != "none":
            raise NotImplementedError(
                "KV-block export requires kv_quant='none' (int8 pools "
                "carry per-position scales the wire format omits)")
        bs = self.block_size
        # bid None: the block left the pool, a tier copy serves it.
        picks: List[tuple] = []            # (index, hash, block id | None)
        tier_payloads: Dict[int, tuple] = {}
        for i, h in enumerate(self.allocator.block_hashes(prompt_tokens)):
            toks = tuple(prompt_tokens[i * bs:(i + 1) * bs])
            entry = self.allocator.lookup_block(h)
            if entry is not None and entry[1] == toks:
                bid: Optional[int] = entry[0]
            elif self.tiers is not None:
                payload = self.tiers.checkout(h, toks)
                if payload is None:
                    break
                bid = None
                tier_payloads[i] = payload
            else:
                break
            if i >= skip_blocks:
                picks.append((i, h, bid))
            if max_blocks > 0 and len(picks) >= max_blocks:
                break
        if not picks:
            return []
        # One gather per pool: only the exported rows leave the device.
        dev = [(i, bid) for i, _, bid in picks if bid is not None]
        if dev:
            k, v = self._read_blocks([bid for _, bid in dev])
        dev_pos = {i: j for j, (i, _) in enumerate(dev)}
        out = []
        for i, h, bid in picks:
            if bid is not None:
                sl = slice(dev_pos[i] * bs, (dev_pos[i] + 1) * bs)
                kb, vb = k[:, :, sl, :], v[:, :, sl, :]
            else:
                kb, vb = tier_payloads[i]
            out.append({"index": i, "hash": h, "k": self._encode(kb),
                        "v": self._encode(vb)})
        return out

    def import_kv_blocks(self, prompt_tokens: Sequence[int],
                         blocks: List[Dict[str, Any]]) -> Dict[str, int]:
        """Adopt shipped prefix blocks into this replica's pool.  Walks the
        prompt's hash chain from block 0: resident blocks count as
        ``skipped``, shipped ones are allocated, written and published
        refcount-0 cached; the walk stops at the first chain gap, malformed
        payload or pool exhaustion (match_prefix serves only contiguous
        prefixes).  Returns ``{"imported": n, "skipped": m}``."""
        if self.kv_quant != "none":
            raise NotImplementedError(
                "KV-block import requires kv_quant='none'")
        bs = self.block_size
        shape = (self.cfg.n_layers, self.cfg.n_kv_heads, bs,
                 self.cfg.head_dim)
        by_index = {int(b["index"]): b for b in blocks}
        imported = skipped = 0
        adopted: List[tuple] = []          # (block id, k array, v array)
        for i, h in enumerate(self.allocator.block_hashes(prompt_tokens)):
            toks = tuple(prompt_tokens[i * bs:(i + 1) * bs])
            entry = self.allocator.lookup_block(h)
            if entry is not None and entry[1] == toks:
                skipped += 1
                continue
            rec = by_index.get(i)
            if rec is None or rec.get("hash", h) != h:
                break
            try:
                k = np.frombuffer(base64.b64decode(rec["k"]),
                                  WIRE_DTYPE).reshape(shape)
                v = np.frombuffer(base64.b64decode(rec["v"]),
                                  WIRE_DTYPE).reshape(shape)
            except (KeyError, ValueError, TypeError):
                break                      # malformed payload: stop clean
            bid = self.allocator.import_block(h, toks)
            if bid is None:
                break                      # pool exhausted
            adopted.append((bid, k, v))
            imported += 1
        if adopted:
            self._write_blocks([bid for bid, _, _ in adopted],
                               np.concatenate([k for _, k, _ in adopted], 2),
                               np.concatenate([v for _, _, v in adopted], 2))
            # The content is in the pool: release to refcount-0 cached,
            # the state a locally prefilled and finished prompt leaves.
            for bid, _, _ in adopted:
                self.allocator.free(bid)
        return {"imported": imported, "skipped": skipped}

    @property
    def stats(self) -> Dict[str, Any]:
        a = self.allocator
        out = {**super().stats,
               "num_blocks": a.num_blocks,
               "free_blocks": a.num_free,
               "prefix_hit_tokens": a.prefix_hits,
               "prefix_query_tokens": a.prefix_queries}
        if self.tiers is not None:
            out.update(self.tiers.stats())
            out["tier_fetch_blocks"] = self.tier_fetch_blocks
            out["tier_demoted_blocks"] = self.tier_demoted_blocks
        return out
