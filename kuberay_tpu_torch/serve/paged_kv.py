"""Paged KV cache with prefix caching, in PyTorch.

Port of ``kuberay_tpu/serve/paged_kv.py`` (without its tensor-parallel
``mesh`` branches):

- one flat physical pool per layer, head-major ``[L, Hkv, num_blocks *
  block_size, D]``, so one page of one kv head is a contiguous run; a
  request's logical cache is a row of physical block ids (its block
  table), padded to ``max_blocks``;
- writes scatter the new K/V into the pool in place, gated per token: a
  padding position's table lookup would land in block 0, which belongs to
  another request, so only real tokens of writable rows are written (torch
  has no ``mode="drop"``: the gated rows are selected before the write);
- decode reads the pool through the block tables in the paged CUDA kernel
  (``ops/paged_attention.py``); prefill gathers per-request views after
  the write, so a call's attention sees its own K/V;
- the int8 pool keeps one float32 scale per (head, position) and feeds
  the dense int8 decode kernel through gathered, made-contiguous views, as
  the JAX package does;
- prefix caching is block-aligned and read-only: a shared block is never
  a write target, so no copy-on-write is needed;
- the block allocator is host-side Python (refcounts, free list, LRU
  reuse of refcount-0 cached blocks), copied whole from the JAX package.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence

import torch

from kuberay_tpu_torch.ops.decode_attention import decode_attention_quant
from kuberay_tpu_torch.ops.paged_attention import (
    flat_indices,
    gather_view,
    paged_decode_attention,
)
from kuberay_tpu_torch.serve.kv_cache import (
    _cached_attention_quant_multi,
    forward_with_cache,
    quantize_kv,
)
from kuberay_tpu_torch.serve.prefix import block_hashes as _prefix_block_hashes
from kuberay_tpu_torch.serve.prefix import chain_hash as _chain_hash


# ---------------------------------------------------------------------------
# Host-side block allocator + prefix cache
# ---------------------------------------------------------------------------

class BlockAllocator:
    """Physical-block bookkeeping: refcounted allocation plus a
    prefix-hash table enabling cross-request block sharing.

    Blocks with refcount 0 that still hold a registered prefix stay in
    the hash table and are reused LRU-last — a free block is only
    scrubbed (hash entry dropped) when allocation demands it.
    """

    def __init__(self, num_blocks: int, block_size: int, *,
                 on_register=None, on_evict=None):
        self.num_blocks = num_blocks
        self.block_size = block_size
        # Membership hooks (hash registered / hash scrubbed), for a tier
        # store that mirrors the pool.
        self.on_register = on_register
        self.on_evict = on_evict
        self.refcount = [0] * num_blocks
        # Free blocks split by cache status so allocate() is O(1): plain
        # deque for uncached, insertion-ordered dict (= LRU) for
        # refcount-0 blocks still holding a registered prefix.
        self._free_uncached: collections.deque = collections.deque(
            range(num_blocks))
        self._free_cached: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        # prefix hash -> (block id, exact block tokens).  The tokens are
        # compared on every match: a 64-bit chained-hash collision must
        # degrade to a cache miss, never silently serve another prompt's
        # KV content.  block id -> hash is kept for eviction.
        self._hash_to_block: Dict[int, tuple] = {}
        self._block_to_hash: Dict[int, int] = {}
        self.prefix_hits = 0          # tokens served from cache
        self.prefix_queries = 0       # tokens eligible for caching

    # -- hashing ----------------------------------------------------------

    def _chain(self, parent: int, block_tokens: Sequence[int]) -> int:
        return _chain_hash(parent, block_tokens)

    def block_hashes(self, tokens: Sequence[int]) -> List[int]:
        """Hash chain over the FULL blocks of a token sequence — the same
        chain the gateway's prefix index keys on (``serve/prefix.py``)."""
        return _prefix_block_hashes(tokens, self.block_size)

    # -- allocation -------------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free_uncached) + len(self._free_cached)

    def allocate(self) -> Optional[int]:
        """Pop a free block, preferring ones with no cached prefix;
        cannibalizing a cached block evicts the LEAST-recently-freed one
        and scrubs its hash entry.  O(1)."""
        if self._free_uncached:
            bid = self._free_uncached.popleft()
        elif self._free_cached:
            bid, _ = self._free_cached.popitem(last=False)   # LRU evict
            h = self._block_to_hash.pop(bid)
            self._hash_to_block.pop(h, None)
            if self.on_evict is not None:
                self.on_evict(h)
        else:
            return None
        self.refcount[bid] = 1
        return bid

    def free(self, bid: int) -> None:
        self.refcount[bid] -= 1
        assert self.refcount[bid] >= 0, f"double free of block {bid}"
        if self.refcount[bid] == 0:
            if bid in self._block_to_hash:         # cached hash survives
                self._free_cached[bid] = None      # MRU end
            else:
                self._free_uncached.append(bid)

    # -- prefix cache -----------------------------------------------------

    def match_prefix(self, tokens: Sequence[int]) -> List[int]:
        """Longest cached block-aligned prefix; increfs every returned
        block (caller owns them and must ``free`` each later)."""
        ids: List[int] = []
        bs = self.block_size
        for i, h in enumerate(self.block_hashes(tokens)):
            entry = self._hash_to_block.get(h)
            if entry is None:
                break
            bid, blk_tokens = entry
            if blk_tokens != tuple(tokens[i * bs:(i + 1) * bs]):
                break                              # hash collision: miss
            if self.refcount[bid] == 0:
                del self._free_cached[bid]         # resurrect cached block
            self.refcount[bid] += 1
            ids.append(bid)
        # Hit/query counters are the CALLER's to bump (count_prefix_stats)
        # — an admission retried while waiting for memory would otherwise
        # re-count the same tokens every engine step.
        return ids

    def count_prefix_stats(self, n_prompt_tokens: int,
                           n_cached_blocks: int) -> None:
        self.prefix_queries += (n_prompt_tokens -
                                n_prompt_tokens % self.block_size)
        self.prefix_hits += n_cached_blocks * self.block_size

    def resident_prefix_blocks(self, tokens: Sequence[int]) -> int:
        """Longest cached block-aligned prefix, in blocks, WITHOUT
        increfing (a pure query).  Token verification matches
        :meth:`match_prefix`: a hash collision reads as non-resident."""
        bs = self.block_size
        depth = 0
        for i, h in enumerate(self.block_hashes(tokens)):
            entry = self._hash_to_block.get(h)
            if entry is None or \
                    entry[1] != tuple(tokens[i * bs:(i + 1) * bs]):
                break
            depth += 1
        return depth

    def lookup_block(self, h: int) -> Optional[tuple]:
        """(block id, exact block tokens) registered under a prefix
        hash, or None."""
        return self._hash_to_block.get(h)

    def hash_of(self, bid: int) -> Optional[int]:
        """Prefix hash published for a block id, or None (private/tail
        blocks never enter the hash table)."""
        return self._block_to_hash.get(bid)

    def registered_hashes(self) -> List[int]:
        """All prefix hashes currently resident in the pool."""
        return list(self._hash_to_block)

    def import_block(self, h: int, block_tokens: Sequence[int]
                     ) -> Optional[int]:
        """Adopt one externally produced prefix block: allocate a
        physical block and publish it in the hash table.  The block comes
        back refcount-1 — the caller writes the KV content into the pool,
        then ``free``s it, after which it is refcount-0 cached.  Returns
        None when the hash is already resident or the pool is exhausted."""
        if h in self._hash_to_block:
            return None                    # already resident; skip
        bid = self.allocate()
        if bid is None:
            return None
        self._hash_to_block[h] = (bid, tuple(block_tokens))
        self._block_to_hash[bid] = h
        if self.on_register is not None:
            self.on_register(h)
        return bid

    def register_prefix(self, tokens: Sequence[int],
                        block_ids: Sequence[int]) -> None:
        """Publish a request's full blocks into the prefix cache (after
        its prefill completed, so the pool contents are valid)."""
        bs = self.block_size
        for i, (h, bid) in enumerate(zip(self.block_hashes(tokens),
                                         block_ids)):
            if h in self._hash_to_block:
                continue               # first writer wins; same content
            if bid in self._block_to_hash:
                continue               # block already published
            self._hash_to_block[h] = (bid, tuple(tokens[i * bs:(i + 1) * bs]))
            self._block_to_hash[bid] = h
            if self.on_register is not None:
                self.on_register(h)


# ---------------------------------------------------------------------------
# Device-side paged forward
# ---------------------------------------------------------------------------

def init_paged_cache(cfg, num_blocks: int, block_size: int,
                     quant: str = "none", device="cuda") -> Dict:
    """Flat physical pool, head-major: [L, Hkv, num_blocks * block_size, D]
    in ``cfg.dtype``; with ``quant="int8"`` each of "k"/"v" is {"q": int8
    [L, Hkv, P, D], "s": float32 [L, Hkv, P]}."""
    shape = (cfg.n_layers, cfg.n_kv_heads, num_blocks * block_size,
             cfg.head_dim)
    if quant == "int8":
        def leaf():
            return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                    "s": torch.zeros(shape[:-1], dtype=torch.float32,
                                     device=device)}
        return {"k": leaf(), "v": leaf()}
    if quant != "none":
        raise ValueError(f"unknown kv quant {quant!r}")
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _physical_positions(block_tables, positions, block_size):
    """[B, T] logical positions -> [B, T] flat pool indices via each row's
    block table.  Positions past the table (bucket padding) resolve
    through its last entry; they are never written."""
    blk = (positions // block_size).clamp(max=block_tables.shape[1] - 1)
    phys_blk = torch.gather(block_tables.long(), 1, blk)
    return phys_blk * block_size + positions % block_size


def gather_scales(spool, tables, block_size: int):
    """[Hkv, P] scale pool + [B, max_blocks] tables -> [B, Hkv, K]
    per-request view in the dense int8 kernel's layout (through the same
    ``flat_indices`` as ``gather_view``: scales resolve through the map of
    their values).  A gathered copy, returned as a transpose."""
    flat = flat_indices(tables, block_size).long()
    return spool[:, flat].transpose(0, 1)


def quant_view(pool: Dict, tables, block_size: int, contiguous: bool):
    """One layer's int8 pool {"q": [Hkv, P, D], "s": [Hkv, P]} as the
    per-request views the dense int8 attention reads: {"q": [B, K, Hkv,
    D], "s": [B, Hkv, K]}; ``contiguous`` copies them into the layout the
    int8 decode kernel takes (the per-layer, per-step cost of this path)."""
    out = {"q": gather_view(pool["q"], tables, block_size),
           "s": gather_scales(pool["s"], tables, block_size)}
    return {k: v.contiguous() for k, v in out.items()} if contiguous else out


def _write_plan(tokens, block_tables, start, write_mask, token_mask,
                block_size):
    """Which new K/V rows are written where: (row, token) indices of the
    gated tokens and their pool positions.  The gate is per token — real
    tokens of writable rows only — since a padding position's lookup
    names another request's block.  One host sync (the boolean select)
    per forward, not per layer."""
    B, T = tokens.shape
    dev = tokens.device
    positions = start[:, None] + torch.arange(T, device=dev)[None, :]
    if write_mask is None:
        write_mask = torch.ones(B, device=dev)
    gate = token_mask if token_mask is not None \
        else write_mask[:, None].expand(B, T)
    b, t = torch.nonzero(gate > 0, as_tuple=True)
    phys = _physical_positions(block_tables, positions, block_size)
    return b, t, phys[b, t]


def _scatter(pool, rows, phys):
    """pool [H, P, ...] <- rows [N, H, ...] at pool positions phys [N]."""
    pool[:, phys] = rows.transpose(0, 1).to(pool.dtype)


def make_paged_forward(block_size: int, base_forward=None):
    """Paged counterpart of ``forward_with_cache`` for a fixed block size.

    The returned ``fwd(cfg, params, tokens, cache, block_tables, start,
    write_mask=None, token_mask=None, logits_index=None)`` takes
    ``block_tables`` [B, max_blocks] int32 of physical block ids per row
    (entries past the live length may be anything: reads stop at the
    length and writes are gated per token).  Writes land in the shared
    pool, so write targets must be disjoint across rows — they are, since
    each live block has one writer and prefix-shared blocks are never
    written.  Decode (T == 1) hands the raw pool and tables to the paged
    kernel; prefill gathers per-request views after the write and runs the
    dense masked attention on them.
    """
    base = base_forward or forward_with_cache

    def fwd(cfg, params, tokens, cache, block_tables, start,
            write_mask=None, token_mask=None, logits_index=None):
        T = tokens.shape[1]
        start = start.to(device=tokens.device, dtype=torch.long)
        tables = block_tables.to(device=tokens.device, dtype=torch.int32)
        b, t, phys = _write_plan(tokens, tables, start, write_mask,
                                 token_mask, block_size)

        def kv_update(ck, cv, kk, vv):                # ck/cv: [Hkv, P, D]
            _scatter(ck, kk[b, t], phys)
            _scatter(cv, vv[b, t], phys)
            if T == 1:
                return ck, cv             # native: attention gets the pool
            return (gather_view(ck, tables, block_size),
                    gather_view(cv, tables, block_size))

        def decode(q, pk, pv, lens, q_positions):
            return paged_decode_attention(q[:, 0].contiguous(), pk, pv,
                                          lens, tables, block_size)[:, None]

        return base(cfg, params, tokens, cache, start, write_mask,
                    token_mask=token_mask, logits_index=logits_index,
                    kv_update=kv_update,
                    attention=decode if T == 1 else None)

    return fwd


def make_paged_quant_forward(block_size: int, base_forward=None):
    """int8 paged pool: quantise-on-write scatter, and per-request
    gathered int8 views read by the dense int8 attention (the decode
    kernel and ``_cached_attention_quant_multi``).  The JAX package's
    design: the gathered int8 view costs a copy of each request's logical
    K/V per layer and step (half the bytes of a bf16 gather), and the
    decode kernel needs it contiguous; the int8 pool's gain is capacity
    (twice the blocks per GB).  Same signature as ``make_paged_forward``'s
    forward."""
    base = base_forward or forward_with_cache

    def fwd(cfg, params, tokens, cache, block_tables, start,
            write_mask=None, token_mask=None, logits_index=None):
        T = tokens.shape[1]
        start = start.to(device=tokens.device, dtype=torch.long)
        tables = block_tables.to(device=tokens.device, dtype=torch.int32)
        b, t, phys = _write_plan(tokens, tables, start, write_mask,
                                 token_mask, block_size)

        def kv_update(ck, cv, kk, vv):        # ck/cv: {"q", "s"} per layer
            kq, ks = quantize_kv(kk[b, t])    # [N, Hkv, D], [N, Hkv, 1]
            vq, vs = quantize_kv(vv[b, t])
            _scatter(ck["q"], kq, phys)
            _scatter(ck["s"], ks[..., 0], phys)
            _scatter(cv["q"], vq, phys)
            _scatter(cv["s"], vs[..., 0], phys)
            return (quant_view(ck, tables, block_size, T == 1),
                    quant_view(cv, tables, block_size, T == 1))

        def decode(q, kv, vv, lens, q_positions):
            return decode_attention_quant(
                q[:, 0].contiguous(), kv["q"], kv["s"], vv["q"], vv["s"],
                lens.to(torch.int32))[:, None]

        return base(cfg, params, tokens, cache, start, write_mask,
                    token_mask=token_mask, logits_index=logits_index,
                    kv_update=kv_update,
                    attention=decode if T == 1
                    else _cached_attention_quant_multi)

    return fwd
