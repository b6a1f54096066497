"""Tiered content-addressed KV block store for the paged engine.

A copy of ``KvTierStore``, ``_describe_tier_metrics`` and the tier
constants of ``kuberay_tpu/serve/kv_tiers.py`` (its gateway-side
``SessionTable`` and ``FleetKvIndex`` stay there: the port's replicas meet
them on the wire, through ``/v1/kv/advert``).  Blocks are keyed by the
chained block hashes of ``serve/prefix.py``:

- **device**: the paged pool owned by ``BlockAllocator``.  The allocator
  stays the source of truth; the store mirrors its membership
  (``note_device``) so adverts cover all three tiers;
- **host**: a bounded LRU of blocks demoted off the device when their last
  reference dropped.  Payloads are opaque to the store (the engine keeps
  float32 numpy copies in the ``export_kv_blocks`` wire layout);
- **spill**: a second bounded LRU fed by host-tier pressure; when it
  overflows, its LRU block is dropped for good (the next miss recomputes).

``checkout`` re-verifies that the stored tokens are exactly the tokens the
caller hashed, so a hash collision or a stale overwrite is a miss, never
wrong K/V.  The engine mutates its store only on the engine-loop thread
(``ServeFrontend.call_engine``); the store takes no locks.  The same
sequence of calls gives the same adverts, ``stats()`` and metric series as
the JAX package's store.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Any, Deque, Dict, Iterable, List, Optional, Tuple

__all__ = ["KvTierStore", "TIER_DEVICE", "TIER_HOST", "TIER_SPILL"]

TIER_DEVICE = "device"
TIER_HOST = "host"
TIER_SPILL = "spill"


def _describe_tier_metrics(metrics) -> None:
    metrics.describe("tpu_kv_tier_blocks",
                     "KV blocks currently resident per tier")
    metrics.describe("tpu_kv_tier_capacity_blocks",
                     "Configured KV block capacity per tier")
    metrics.describe("tpu_kv_tier_hits_total",
                     "Tier-store checkouts that returned a block, per tier")
    metrics.describe("tpu_kv_tier_misses_total",
                     "Tier-store checkouts that found no block")
    metrics.describe("tpu_kv_tier_demotions_total",
                     "Blocks demoted between tiers (src/dst labelled)")
    metrics.describe("tpu_kv_tier_promotions_total",
                     "Blocks promoted toward device (source tier labelled)")
    metrics.describe("tpu_kv_tier_evictions_total",
                     "Blocks dropped from the bottom of the hierarchy")
    metrics.describe("tpu_kv_tier_stale_drops_total",
                     "Checkouts whose stored tokens mismatched the hash "
                     "(entry dropped instead of served)")


class KvTierStore:
    """Host + spill LRU tiers with capacity accounting and an advert log.

    ``host_blocks``/``spill_blocks`` are capacities in KV blocks; a tier
    with capacity 0 is disabled.  ``admit`` lands a block in the host
    tier, demoting host→spill (and spill→gone) under pressure, skipping
    pinned entries.  ``checkout`` verifies content and promotes
    spill→host on hit.  Each membership change appends to a bounded
    advert log; readers poll ``advert_since(seq)`` and get either a
    delta or, after falling behind the log window, a full snapshot.
    """

    def __init__(self, host_blocks: int, spill_blocks: int = 0, *,
                 metrics=None, advert_capacity: int = 4096):
        self.host_blocks = int(host_blocks)
        self.spill_blocks = int(spill_blocks)
        # hash -> (tokens tuple, opaque payload); OrderedDict end = MRU.
        self._host: "OrderedDict[int, Tuple[Tuple[int, ...], Any]]" = \
            OrderedDict()
        self._spill: "OrderedDict[int, Tuple[Tuple[int, ...], Any]]" = \
            OrderedDict()
        self._pins: Dict[int, int] = {}
        # Device-tier mirror (membership only; payloads live in the pool).
        self._device: Dict[int, None] = {}
        # Hashes freed on device and awaiting an async device->host copy.
        self._pending: "OrderedDict[int, None]" = OrderedDict()
        self._advert: Deque[Tuple[int, str, str, int]] = \
            deque(maxlen=max(16, int(advert_capacity)))
        self._seq = 0
        self._metrics = metrics
        self.hits = {TIER_HOST: 0, TIER_SPILL: 0}
        self.misses = 0
        self.demotions = 0
        self.promotions = 0
        self.evictions = 0
        self.stale_drops = 0
        if metrics is not None:
            _describe_tier_metrics(metrics)
            metrics.set_gauge("tpu_kv_tier_capacity_blocks",
                              float(self.host_blocks),
                              {"tier": TIER_HOST})
            metrics.set_gauge("tpu_kv_tier_capacity_blocks",
                              float(self.spill_blocks),
                              {"tier": TIER_SPILL})

    # ---------------------------------------------------------- advert log

    def _record(self, op: str, tier: str, h: int) -> None:
        self._seq += 1
        self._advert.append((self._seq, op, tier, h))

    @property
    def advert_seq(self) -> int:
        return self._seq

    def advert_since(self, seq: int) -> Dict[str, Any]:
        """Delta of membership changes after ``seq``, or a snapshot.

        Returns ``{"seq", "reset", "add": [[hash, tier], ...],
        "del": [hash, ...]}``.  A reader that fell out of the bounded
        log window (or asks from seq 0) gets ``reset: True`` with the
        full residency listing across all three tiers.
        """
        if seq >= self._seq:
            return {"seq": self._seq, "reset": False, "add": [], "del": []}
        oldest = self._advert[0][0] if self._advert else self._seq + 1
        if seq + 1 < oldest:
            add = ([[h, TIER_DEVICE] for h in self._device]
                   + [[h, TIER_HOST] for h in self._host]
                   + [[h, TIER_SPILL] for h in self._spill])
            return {"seq": self._seq, "reset": True, "add": add, "del": []}
        add: List[List[Any]] = []
        dels: List[int] = []
        for s, op, tier, h in self._advert:
            if s <= seq:
                continue
            if op == "add":
                add.append([h, tier])
            else:
                dels.append(h)
        return {"seq": self._seq, "reset": False, "add": add, "del": dels}

    # ------------------------------------------------------- device mirror

    def note_device(self, h: int, present: bool) -> None:
        """Mirror device-pool membership (called from allocator hooks).

        A block registered on device no longer needs a pending demotion
        copy; a block evicted from device stays wherever the hierarchy
        already holds it.
        """
        if present:
            if h not in self._device:
                self._device[h] = None
                self._record("add", TIER_DEVICE, h)
        else:
            if h in self._device:
                del self._device[h]
                self._record("del", TIER_DEVICE, h)
            self._pending.pop(h, None)

    def note_freed(self, h: int) -> None:
        """Queue a device-resident block for asynchronous demotion.

        Called when the last sequence reference drops; the engine's step
        pump later copies the block host-ward (bounded per step) while
        it is still resident in the pool.
        """
        if h in self._host or h in self._spill:
            return
        self._pending[h] = None
        self._pending.move_to_end(h)

    def pop_pending(self) -> Optional[int]:
        """Next hash awaiting a device->host copy (FIFO), or None."""
        if not self._pending:
            return None
        h, _ = self._pending.popitem(last=False)
        return h

    def pending_count(self) -> int:
        return len(self._pending)

    # -------------------------------------------------------------- tiers

    def admit(self, h: int, tokens: Iterable[int], payload: Any) -> bool:
        """Land a block in the host tier, demoting under pressure.

        Returns False when the host tier is disabled or full of pinned
        entries (the block is simply not kept).
        """
        if self.host_blocks <= 0:
            return False
        tokens = tuple(tokens)
        self._pending.pop(h, None)
        if h in self._host:
            self._host.move_to_end(h)
            return True
        if h in self._spill:
            # Re-admission from spill is a promotion within the store.
            del self._spill[h]
            self._record("del", TIER_SPILL, h)
        self._host[h] = (tokens, payload)
        self._record("add", TIER_HOST, h)
        self._evict_pressure()
        if h not in self._host:
            return False
        self._gauge()
        return True

    def _evict_pressure(self) -> None:
        while len(self._host) > self.host_blocks:
            victim = self._lru_unpinned(self._host)
            if victim is None:
                # Everything pinned: shed the newest admit instead of
                # blocking (callers treat a failed admit as a drop).
                victim = next(reversed(self._host))
            toks, payload = self._host.pop(victim)
            self._record("del", TIER_HOST, victim)
            if self.spill_blocks > 0:
                self._spill[victim] = (toks, payload)
                self._spill.move_to_end(victim)
                self._record("add", TIER_SPILL, victim)
                self.demotions += 1
                if self._metrics is not None:
                    self._metrics.inc("tpu_kv_tier_demotions_total",
                                      {"src": TIER_HOST, "dst": TIER_SPILL})
            else:
                self.evictions += 1
                if self._metrics is not None:
                    self._metrics.inc("tpu_kv_tier_evictions_total",
                                      {"tier": TIER_HOST})
        while len(self._spill) > self.spill_blocks:
            victim = self._lru_unpinned(self._spill)
            if victim is None:
                victim = next(reversed(self._spill))
            self._spill.pop(victim)
            self._record("del", TIER_SPILL, victim)
            self.evictions += 1
            if self._metrics is not None:
                self._metrics.inc("tpu_kv_tier_evictions_total",
                                  {"tier": TIER_SPILL})

    def _lru_unpinned(self, tier: "OrderedDict") -> Optional[int]:
        for h in tier:
            if self._pins.get(h, 0) <= 0:
                return h
        return None

    def checkout(self, h: int, tokens: Iterable[int]) -> Optional[Any]:
        """Content-verified read: the payload for ``h``, or None.

        The caller supplies the exact tokens it hashed; a stored entry
        whose tokens differ is dropped (counted as a stale drop) rather
        than served — a block served under hash H must contain exactly
        the tokens that hash to H.  A spill hit is promoted to the host
        tier on its way out.
        """
        tokens = tuple(tokens)
        for tier_name, tier in ((TIER_HOST, self._host),
                                (TIER_SPILL, self._spill)):
            entry = tier.get(h)
            if entry is None:
                continue
            stored_tokens, payload = entry
            if stored_tokens != tokens:
                del tier[h]
                self._record("del", tier_name, h)
                self.stale_drops += 1
                if self._metrics is not None:
                    self._metrics.inc("tpu_kv_tier_stale_drops_total")
                self._gauge()
                return None
            self.hits[tier_name] += 1
            if self._metrics is not None:
                self._metrics.inc("tpu_kv_tier_hits_total",
                                  {"tier": tier_name})
            if tier_name == TIER_SPILL:
                del self._spill[h]
                self._record("del", TIER_SPILL, h)
                self._host[h] = (stored_tokens, payload)
                self._record("add", TIER_HOST, h)
                self.promotions += 1
                if self._metrics is not None:
                    self._metrics.inc("tpu_kv_tier_promotions_total",
                                      {"src": TIER_SPILL})
                self._evict_pressure()
            else:
                self._host.move_to_end(h)
            self._gauge()
            return payload
        self.misses += 1
        if self._metrics is not None:
            self._metrics.inc("tpu_kv_tier_misses_total")
        return None

    def pin(self, h: int) -> None:
        """Exclude ``h`` from tier eviction until ``unpin``."""
        self._pins[h] = self._pins.get(h, 0) + 1

    def unpin(self, h: int) -> None:
        n = self._pins.get(h, 0) - 1
        if n <= 0:
            self._pins.pop(h, None)
        else:
            self._pins[h] = n

    def tier_of(self, h: int) -> Optional[str]:
        if h in self._device:
            return TIER_DEVICE
        if h in self._host:
            return TIER_HOST
        if h in self._spill:
            return TIER_SPILL
        return None

    def contains(self, h: int) -> bool:
        return h in self._host or h in self._spill

    def discard(self, h: int) -> int:
        """Drop ``h`` from every tier; returns how many tier copies
        actually left (0 = the hash was not resident)."""
        n = 0
        if self._host.pop(h, None) is not None:
            self._record("del", TIER_HOST, h)
            n += 1
        if self._spill.pop(h, None) is not None:
            self._record("del", TIER_SPILL, h)
            n += 1
        self._pending.pop(h, None)
        self._gauge()
        return n

    def _gauge(self) -> None:
        if self._metrics is None:
            return
        self._metrics.set_gauge("tpu_kv_tier_blocks",
                                float(len(self._host)),
                                {"tier": TIER_HOST})
        self._metrics.set_gauge("tpu_kv_tier_blocks",
                                float(len(self._spill)),
                                {"tier": TIER_SPILL})

    def stats(self) -> Dict[str, Any]:
        return {
            "host_blocks_used": len(self._host),
            "host_blocks_total": self.host_blocks,
            "spill_blocks_used": len(self._spill),
            "spill_blocks_total": self.spill_blocks,
            "pending_demotions": len(self._pending),
            "tier_hits_host": self.hits[TIER_HOST],
            "tier_hits_spill": self.hits[TIER_SPILL],
            "tier_misses": self.misses,
            "tier_demotions": self.demotions,
            "tier_promotions": self.promotions,
            "tier_evictions": self.evictions,
            "tier_stale_drops": self.stale_drops,
            "advert_seq": self._seq,
        }
