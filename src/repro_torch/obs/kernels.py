"""Kernel dispatch profiler for the kernel wrapper call sites.

Every bucketed dispatch in ``find_pattern_mask_batch`` and
``digest_signature_batch`` reports here, under the same counter names
as the reference package:

* ``kernel.<name>.dispatches`` / ``.rows`` — dispatch and row volume;
* ``kernel.<name>.useful_bytes`` vs ``.padded_bytes`` — real payload
  bytes vs the (padded_rows × width) matrix shipped to the kernel;
* per width bucket: ``kernel.<name>.w<width>.{dispatches,useful_bytes,
  padded_bytes}``;
* ``kernel.<name>.shape_compiles`` vs ``.shape_reuses`` — distinct
  (width, padded_rows) shapes seen in-process vs dispatches that repeat
  one. The seen-set is process-global, not tied to a registry.
"""
from __future__ import annotations

import threading
from typing import Dict, Set, Tuple

from .registry import ObsSnapshot

__all__ = ["pad_waste_report", "record_dispatch", "reset_shape_cache"]

_seen_shapes: Set[Tuple[str, int, int]] = set()
_shapes_lock = threading.Lock()


def record_dispatch(kernel: str, *, width: int, rows: int,
                    padded_rows: int, useful_bytes: int) -> None:
    """Account one bucketed kernel dispatch.

    ``rows`` is the number of real rows packed, ``padded_rows`` the row
    count after padding, and ``useful_bytes`` the sum of true payload
    sizes in the bucket.
    """
    from repro_torch import obs

    padded_bytes = padded_rows * width
    base = f"kernel.{kernel}"
    with _shapes_lock:
        shape = (kernel, width, padded_rows)
        fresh = shape not in _seen_shapes
        if fresh:
            _seen_shapes.add(shape)
    obs.registry().fold_counters({
        f"{base}.dispatches": 1,
        f"{base}.rows": rows,
        f"{base}.useful_bytes": useful_bytes,
        f"{base}.padded_bytes": padded_bytes,
        f"{base}.w{width}.dispatches": 1,
        f"{base}.w{width}.useful_bytes": useful_bytes,
        f"{base}.w{width}.padded_bytes": padded_bytes,
        (f"{base}.shape_compiles" if fresh else f"{base}.shape_reuses"): 1,
    })


def reset_shape_cache() -> None:
    """Forget seen shapes (tests only)."""
    with _shapes_lock:
        _seen_shapes.clear()


def pad_waste_report(snap: ObsSnapshot) -> Dict[str, Dict[str, object]]:
    """Distill per-kernel pad-waste and shape-reuse from a snapshot.

    Returns ``{kernel: {dispatches, useful_bytes, padded_bytes,
    pad_waste_ratio, shape_reuse_rate, buckets: {width: waste_ratio}}}``.
    """
    out: Dict[str, Dict[str, object]] = {}
    for name, v in snap.counters.items():
        if not name.startswith("kernel."):
            continue
        parts = name.split(".")
        if len(parts) < 3:
            continue
        k = out.setdefault(parts[1], {"dispatches": 0, "useful_bytes": 0,
                                      "padded_bytes": 0, "shape_compiles": 0,
                                      "shape_reuses": 0, "buckets": {}})
        tail = parts[2]
        if tail in ("dispatches", "useful_bytes", "padded_bytes",
                    "shape_compiles", "shape_reuses") and len(parts) == 3:
            k[tail] += v
        elif tail.startswith("w") and tail[1:].isdigit() and len(parts) == 4:
            b = k["buckets"].setdefault(int(tail[1:]),
                                        {"useful_bytes": 0,
                                         "padded_bytes": 0, "dispatches": 0})
            b[parts[3]] += v
    for k in out.values():
        padded = k["padded_bytes"]
        k["pad_waste_ratio"] = (
            1.0 - k["useful_bytes"] / padded if padded else 0.0)
        disp = k["shape_compiles"] + k["shape_reuses"]
        k["shape_reuse_rate"] = k["shape_reuses"] / disp if disp else 0.0
        for b in k["buckets"].values():
            bp = b["padded_bytes"]
            b["pad_waste_ratio"] = (
                1.0 - b["useful_bytes"] / bp if bp else 0.0)
    return out
