"""Byte-budgeted LRU cache of decompressed record payloads.

The gateway-level counterpart of the paper's decompression bottleneck:
under concurrent query traffic the same few hot records are fetched (and
therefore decompressed) over and over — exactly the repeated work the
archive-scale analytics discipline says to aggregate away. Entries are
keyed by ``(shard_id, offset)`` (the CDX-addressable identity of a
record) and the budget is in *bytes*, not entries, because archive
payloads are wildly ragged: a handful of megabyte pages must not be
allowed to masquerade as a "small" cache.

Admission is guarded by a TinyLFU-style frequency sketch
(:class:`FrequencySketch`): before an insert may evict, the candidate's
estimated access frequency must beat the eviction victim's. Archive
query traffic is scan-heavy — one indexed query can touch thousands of
records exactly once — and under plain LRU a single such scan flushes
the hot working set; the sketch makes one-shot keys lose the admission
duel instead (``admission="lru"`` admits unconditionally).

Thread-safe; eviction among admitted entries is strict LRU. Payloads
larger than the whole budget are not admitted (one oversize record must
not flush everything).
"""
from __future__ import annotations

import hashlib
import threading
from bisect import bisect_right
from collections import OrderedDict

import numpy as np

__all__ = ["FrequencySketch", "RecordCache", "ShardedRecordCache"]


class FrequencySketch:
    """Count-min sketch with saturating 4-bit-style counters + aging.

    The TinyLFU frequency oracle: ``record`` bumps ``depth`` hashed
    counters (conservative increment — only the current minima move, so
    one key cannot inflate another's estimate more than necessary) and
    ``estimate`` reads their minimum. After ``sample_size`` recordings
    every counter is halved — the classic reset that lets the sketch
    track a *moving* working set instead of all of history.

    Counters live in plain ``bytearray`` rows and the per-access path is
    pure-int: it runs on every ``RecordCache.get``/``put`` *inside the
    cache lock*, where numpy scalar dispatch (~µs per op) would tax the
    gateway's record-fetch hot loop; only the amortized aging sweep
    touches numpy.
    """

    _SEEDS = (0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)
    _CAP = 15  # saturation: 4-bit counters, as in the TinyLFU paper
    _M64 = 0xFFFFFFFFFFFFFFFF

    def __init__(self, capacity_hint: int = 4096, *, depth: int = 4,
                 sample_factor: int = 8) -> None:
        if depth < 1 or depth > len(self._SEEDS):
            raise ValueError(f"depth must be in [1, {len(self._SEEDS)}]")
        width = 1
        while width < max(capacity_hint, 16):
            width <<= 1
        self._width_mask = width - 1
        self._counts = [bytearray(width) for _ in range(depth)]
        self._depth = depth
        self.sample_size = sample_factor * width
        self._recorded = 0
        self.ages = 0

    def _slots(self, key) -> list[int]:
        h = hash(key) & self._M64
        h ^= h >> 33
        slots = []
        for seed in self._SEEDS[:self._depth]:
            m = (h * seed) & self._M64
            slots.append(((m >> 17) ^ m) & self._width_mask)
        return slots

    def record(self, key) -> None:
        """Count one access attempt for ``key`` (hit or miss alike)."""
        idx = self._slots(key)
        counts = self._counts
        lo = min(counts[r][i] for r, i in enumerate(idx))
        if lo < self._CAP:  # conservative increment of the minima only
            for r, i in enumerate(idx):
                if counts[r][i] == lo:
                    counts[r][i] = lo + 1
        self._recorded += 1
        if self._recorded >= self.sample_size:
            for row in counts:  # aging: halve everything (amortized)
                row[:] = (np.frombuffer(row, np.uint8) >> 1).tobytes()
            self._recorded //= 2
            self.ages += 1

    def estimate(self, key) -> int:
        return min(self._counts[r][i]
                   for r, i in enumerate(self._slots(key)))


class RecordCache:
    """LRU over ``(shard_id, offset) -> bytes`` with a byte budget.

    ``admission="tinylfu"`` (the gateway default) gates evicting inserts
    behind the frequency duel described in the module docstring;
    ``admission="lru"`` admits unconditionally.
    """

    def __init__(self, budget_bytes: int, *, admission: str = "lru",
                 sketch: FrequencySketch | None = None) -> None:
        if budget_bytes < 0:
            raise ValueError("budget_bytes must be >= 0")
        if admission not in ("lru", "tinylfu"):
            raise ValueError(f"unknown admission policy {admission!r}")
        self.budget_bytes = budget_bytes
        self.admission = admission
        self._sketch = (sketch if sketch is not None
                        else FrequencySketch() if admission == "tinylfu"
                        else None)
        self._entries: "OrderedDict[tuple[int, int], bytes]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.rejected_oversize = 0
        self.rejected_admission = 0
        self.bytes_filled = 0  # bytes admitted over the cache's lifetime

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def bytes_cached(self) -> int:
        return self._bytes

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def get(self, key: tuple[int, int]) -> bytes | None:
        with self._lock:
            if self._sketch is not None:
                self._sketch.record(key)  # every access attempt counts
            data = self._entries.get(key)
            if data is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return data

    def put(self, key: tuple[int, int], data: bytes) -> bool:
        """Admit ``data``; returns False when it exceeds the budget or
        (TinyLFU) loses the admission duel against the eviction victim."""
        size = len(data)
        with self._lock:
            if self._sketch is not None:
                # an insertion attempt is an access attempt too: without
                # this, a put-without-prior-get workload leaves every
                # candidate at estimate 0 and the duel (<=) freezes the
                # cache on whatever was admitted first
                self._sketch.record(key)
            if size > self.budget_bytes:
                self.rejected_oversize += 1
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            if self._sketch is not None and self._bytes + size > \
                    self.budget_bytes:
                # the insert must evict: the candidate duels *every* entry
                # it would displace (LRU → MRU until enough bytes free) —
                # dueling only the LRU head would let one large candidate
                # beat a stale victim and then flush arbitrarily many hot
                # entries the duel never consulted
                cand_freq = self._sketch.estimate(key)
                need = self._bytes + size - self.budget_bytes
                freed = 0
                admitted = True
                for vkey, vdata in self._entries.items():
                    if freed >= need:
                        break
                    if cand_freq <= self._sketch.estimate(vkey):
                        admitted = False
                        break
                    freed += len(vdata)
                if not admitted:
                    self.rejected_admission += 1
                    if old is not None:  # key was resident: keep old value
                        self._entries[key] = old
                        self._bytes += len(old)
                        self._entries.move_to_end(key)
                    return False
            self._entries[key] = data
            self._bytes += size
            self.bytes_filled += size
            while self._bytes > self.budget_bytes:
                _, evicted = self._entries.popitem(last=False)
                self._bytes -= len(evicted)
                self.evictions += 1
            return True

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def snapshot(self) -> dict:
        """Counters for the metrics surface."""
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes_cached": self._bytes,
                "budget_bytes": self.budget_bytes,
                "admission": self.admission,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "rejected_oversize": self.rejected_oversize,
                "rejected_admission": self.rejected_admission,
                "bytes_filled": self.bytes_filled,
                "hit_rate": self.hit_rate,
            }


class ShardedRecordCache:
    """Consistent-hash ring of :class:`RecordCache` slices.

    The sharded gateway runs N scheduler shards against one payload
    cache; a plain shared cache would work but couple every shard's
    fate (one death evicts everything) — and N *independent* caches
    would duplicate hot bytes N times. Consistent hashing gives both
    properties the sharded gateway wants:

    * every key is owned by exactly **one** slice (no duplicated hot
      bytes);
    * removing a slice (a shard retired after exhausting its respawn
      budget) remaps only *its* arc of the ring — keys owned by
      surviving slices keep their placement and their heat;
    * a transient shard death clears only its own slice
      (:meth:`clear_slice`), bounding the cold-start to 1/N of the
      budget.

    The key → slice map uses ``vnodes`` virtual points per slice
    (default 64) hashed with ``blake2b`` — process-independent and
    uniform enough that a zipfian workload's hit rate stays close to
    that of a single cache of the same total budget. ``n_slices=1``
    short-circuits all ring math: the
    single-shard gateway pays nothing for the generality.

    Thread-safe: slice routing state is read-mostly (rebuilt only on
    :meth:`remove_slice`, under a lock); each slice carries its own
    lock, so shards hitting different slices don't contend.
    """

    def __init__(self, budget_bytes: int, n_slices: int = 1, *,
                 admission: str = "tinylfu", vnodes: int = 64) -> None:
        if budget_bytes < 0:
            raise ValueError("budget_bytes must be >= 0")
        n = max(1, int(n_slices))
        base, extra = divmod(budget_bytes, n)
        self._slices = [RecordCache(base + (1 if i < extra else 0),
                                    admission=admission)
                        for i in range(n)]
        self.n_slices = n
        self.admission = admission
        self.budget_bytes = budget_bytes
        self._vnodes = max(1, int(vnodes))
        self._removed: set[int] = set()
        self._ring_lock = threading.Lock()
        self._rebuild_ring()

    # -- ring -------------------------------------------------------------
    @staticmethod
    def _hash(obj) -> int:
        digest = hashlib.blake2b(repr(obj).encode("utf-8",
                                                  "backslashreplace"),
                                 digest_size=8).digest()
        return int.from_bytes(digest, "big")

    def _rebuild_ring(self) -> None:
        points: list[tuple[int, int]] = []
        for i in range(self.n_slices):
            if i in self._removed:
                continue
            points.extend((self._hash(("slice", i, v)), i)
                          for v in range(self._vnodes))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [o for _, o in points]

    def slice_for(self, key) -> int | None:
        """The slice owning ``key`` (``None`` when every slice is
        removed). Deterministic and stable across processes."""
        if self.n_slices == 1:
            return None if 0 in self._removed else 0
        points = self._points  # snapshot: rebuilds swap, never mutate
        if not points:
            return None
        i = bisect_right(points, self._hash(key)) % len(points)
        return self._owners[i]

    # -- cache surface (RecordCache-compatible) ---------------------------
    def get(self, key) -> bytes | None:
        owner = self.slice_for(key)
        return None if owner is None else self._slices[owner].get(key)

    def put(self, key, data: bytes) -> bool:
        owner = self.slice_for(key)
        return False if owner is None else self._slices[owner].put(key, data)

    def clear(self) -> None:
        for sl in self._slices:
            sl.clear()

    def clear_slice(self, i: int) -> None:
        """Evict one slice's residents (transient shard death): siblings
        keep their heat, the cold-start is bounded to this slice."""
        self._slices[i].clear()

    def remove_slice(self, i: int) -> None:
        """Retire one slice from the ring (permanent shard death): its
        arc remaps to the survivors, every other key keeps its owner."""
        with self._ring_lock:
            if i in self._removed:
                return
            self._removed.add(i)
            self._rebuild_ring()
        self._slices[i].clear()

    @property
    def slices(self) -> "list[RecordCache]":
        return self._slices

    def __len__(self) -> int:
        return sum(len(sl) for sl in self._slices)

    @property
    def bytes_cached(self) -> int:
        return sum(sl.bytes_cached for sl in self._slices)

    @property
    def hits(self) -> int:
        return sum(sl.hits for sl in self._slices)

    @property
    def misses(self) -> int:
        return sum(sl.misses for sl in self._slices)

    @property
    def evictions(self) -> int:
        return sum(sl.evictions for sl in self._slices)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def snapshot(self) -> dict:
        """Aggregated counters (same keys as :meth:`RecordCache.snapshot`
        so the metrics surface is shape-stable) + slice accounting."""
        per = [sl.snapshot() for sl in self._slices]
        out = {
            "entries": sum(p["entries"] for p in per),
            "bytes_cached": sum(p["bytes_cached"] for p in per),
            "budget_bytes": self.budget_bytes,
            "admission": self.admission,
            "hits": sum(p["hits"] for p in per),
            "misses": sum(p["misses"] for p in per),
            "evictions": sum(p["evictions"] for p in per),
            "rejected_oversize": sum(p["rejected_oversize"] for p in per),
            "rejected_admission": sum(p["rejected_admission"] for p in per),
            "bytes_filled": sum(p["bytes_filled"] for p in per),
            "hit_rate": self.hit_rate,
            "slices": self.n_slices,
            "slices_removed": len(self._removed),
        }
        return out
