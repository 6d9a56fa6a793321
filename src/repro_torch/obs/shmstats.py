"""Seqlock-framed shared-memory stats blocks for child processes.

A pool worker publishes cumulative
:class:`~repro_torch.obs.registry.ObsSnapshot` pickles into a fixed slot
of a shared-memory segment the *parent* owns; the parent harvests
whenever it likes (supervisor tick, stream end, ``close()``) without any
handshake.
Because the parent owns the segment, a SIGKILLed child's last published
snapshot survives it — that is the whole point: worker counters used to
die with the worker.

Slot layout (little-endian)::

    u64 seq     even = stable, odd = write in progress (seqlock)
    u32 len     payload byte length
    len bytes   pickled ObsSnapshot

Writers bump ``seq`` to odd, write payload+len, then bump to even;
readers retry on odd or torn (seq changed mid-read) frames. A snapshot
too large for the slot is dropped on the floor (publishing is best
effort — the counters are cumulative, the next smaller publish or the
final one usually fits; oversize drops are themselves counted by the
writer under ``obs.stats_publish_oversize``).
"""
from __future__ import annotations

import pickle
import struct
from typing import Optional

from .registry import ObsSnapshot

__all__ = ["STATS_SLOT_BYTES", "StatsSlotReader", "StatsSlotWriter"]

#: Per-worker slot size. Snapshots are a few KiB of counters; 32 KiB
#: leaves headroom for histogram reservoirs without bloating segments.
STATS_SLOT_BYTES = 32 << 10

_HDR = struct.Struct("<QI")


class StatsSlotWriter:
    """Child-side publisher for one stats slot (a memoryview into shm)."""

    __slots__ = ("_buf", "_seq", "oversize_drops")

    def __init__(self, buf) -> None:
        self._buf = memoryview(buf)
        self._seq = _HDR.unpack_from(self._buf, 0)[0]
        if self._seq & 1:  # stale odd marker from a dead predecessor
            self._seq += 1
        self.oversize_drops = 0

    def publish(self, snap: ObsSnapshot) -> bool:
        payload = pickle.dumps(snap, protocol=pickle.HIGHEST_PROTOCOL)
        cap = len(self._buf) - _HDR.size
        if len(payload) > cap:
            self.oversize_drops += 1
            return False
        seq = self._seq + 1  # odd: write in progress
        _HDR.pack_into(self._buf, 0, seq, len(payload))
        self._buf[_HDR.size:_HDR.size + len(payload)] = payload
        self._seq = seq + 1  # even: stable
        _HDR.pack_into(self._buf, 0, self._seq, len(payload))
        return True

    def close(self) -> None:
        """Release the memoryview export (must precede ``shm.close()``)."""
        self._buf.release()


class StatsSlotReader:
    """Parent-side harvester for one stats slot."""

    __slots__ = ("_buf",)

    def __init__(self, buf) -> None:
        self._buf = memoryview(buf)

    def read(self, retries: int = 8) -> Optional[ObsSnapshot]:
        """Latest stable snapshot in the slot, or ``None`` if the slot is
        empty, torn beyond ``retries``, or holds a corrupt frame."""
        for _ in range(retries):
            seq1, length = _HDR.unpack_from(self._buf, 0)
            if seq1 == 0 and length == 0:
                return None  # never written
            if seq1 & 1:
                continue  # write in progress
            if length > len(self._buf) - _HDR.size:
                return None
            payload = bytes(self._buf[_HDR.size:_HDR.size + length])
            seq2 = _HDR.unpack_from(self._buf, 0)[0]
            if seq1 != seq2:
                continue  # torn: overwritten mid-read
            try:
                snap = pickle.loads(payload)
            except Exception:
                return None
            return snap if isinstance(snap, ObsSnapshot) else None
        return None

    def close(self) -> None:
        """Release the memoryview export (must precede ``shm.close()``)."""
        self._buf.release()
