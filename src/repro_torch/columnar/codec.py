"""Generic column codec: contiguous-array packing + a TOC'd container.

Two layers, both byte-compatible with the reference package's codec:

* **array packing** — :func:`pack_arrays` / :class:`ArrayCursor`: the
  fixed, implicit column schema of
  :meth:`repro_torch.index.cdx.CdxIndex.save` and ``load`` (the v2 byte
  format).

* **TOC'd container** — :class:`ColumnWriter` / :class:`ColumnFile`:
  a versioned single-file layout for *self-describing* column sets —
  magic + header, 64-byte-aligned sections (named numpy arrays and raw
  byte blobs, blobs streamable chunk-by-chunk so a derive never holds
  the packed payload in RAM), and a trailing JSON table of contents
  (section name/kind/dtype/shape/offset plus free-form ``meta``),
  written last so an interrupted write never looks complete.
  :class:`ColumnFile` mmaps the file and hands out **zero-copy views**:
  ``array()`` / ``view()`` return numpy arrays backed by the mapping.

Ownership rule: views borrow the mapping. ``close()`` refuses — raises
``BufferError`` — while borrowed views are alive; drop them (or copy
out) first. A columnar scan must not copy the corpus to read it.
"""
from __future__ import annotations

import json
import mmap
import struct
from typing import Any

import numpy as np

__all__ = ["ArrayCursor", "ColumnFile", "ColumnWriter", "pack_arrays"]

_MAGIC = b"REPROCOL"
_VERSION = 1
_ALIGN = 64  # section alignment: cache-line friendly mmap views
_HEADER = "<IIQQ"  # version, reserved, toc_off, toc_len (after the magic)


def pack_arrays(out, arrays) -> None:
    """Write arrays back-to-back as contiguous bytes (no framing — the
    schema is the caller's contract, as in the CDX fixed column order)."""
    for arr in arrays:
        out.write(np.ascontiguousarray(arr).tobytes())


class ArrayCursor:
    """Decode arrays packed by :func:`pack_arrays` from a bytes-like.

    Zero-copy: each :meth:`take` is an ``np.frombuffer`` view advancing
    an offset.
    """

    def __init__(self, blob, pos: int = 0) -> None:
        self.blob = blob
        self.pos = pos

    def take(self, dtype, count: int, shape=None) -> np.ndarray:
        arr = np.frombuffer(self.blob, dtype, count, self.pos)
        self.pos += arr.nbytes
        return arr.reshape(shape) if shape else arr


class ColumnWriter:
    """Streaming writer for the TOC'd column container.

    Arrays are written whole; blobs are opened, appended chunk-by-chunk
    (:meth:`append` returns each chunk's blob-relative offset — row-group
    tables are built from these), and closed. :meth:`close` writes the
    TOC and patches the header; the file is invalid until then.
    """

    def __init__(self, path: str, *, meta: dict[str, Any] | None = None
                 ) -> None:
        self.path = path
        self._f = open(path, "wb")
        self._f.write(_MAGIC + struct.pack(_HEADER, _VERSION, 0, 0, 0))
        self._sections: list[dict[str, Any]] = []
        self._names: set[str] = set()
        self.meta: dict[str, Any] = dict(meta or {})
        self._blob: dict[str, Any] | None = None

    def _align(self) -> int:
        pad = -self._f.tell() % _ALIGN
        if pad:
            self._f.write(b"\0" * pad)
        return self._f.tell()

    def _claim(self, name: str) -> None:
        if self._blob is not None:
            raise ValueError(f"blob {self._blob['name']!r} still open")
        if name in self._names:
            raise ValueError(f"duplicate section {name!r}")
        self._names.add(name)

    def add_array(self, name: str, arr) -> None:
        self._claim(name)
        arr = np.ascontiguousarray(arr)
        off = self._align()
        self._f.write(arr.tobytes())
        self._sections.append({"name": name, "kind": "array",
                               "dtype": arr.dtype.str,
                               "shape": list(arr.shape),
                               "offset": off, "nbytes": arr.nbytes})

    def begin_blob(self, name: str) -> None:
        self._claim(name)
        self._blob = {"name": name, "kind": "blob",
                      "offset": self._align(), "nbytes": 0}

    def append(self, data) -> int:
        """Append a chunk to the open blob; returns its blob-relative
        start offset (what a row-group table records)."""
        if self._blob is None:
            raise ValueError("no blob open")
        rel = self._blob["nbytes"]
        mv = memoryview(data)  # any C-contiguous buffer (bytes, ndarray)
        self._f.write(mv)
        self._blob["nbytes"] += mv.nbytes
        return rel

    def end_blob(self) -> None:
        if self._blob is None:
            raise ValueError("no blob open")
        self._sections.append(self._blob)
        self._blob = None

    def add_blob(self, name: str, data) -> None:
        self.begin_blob(name)
        self.append(data)
        self.end_blob()

    def close(self) -> None:
        if self._f.closed:
            return
        if self._blob is not None:
            raise ValueError(f"blob {self._blob['name']!r} still open")
        toc = json.dumps({"meta": self.meta, "sections": self._sections},
                         separators=(",", ":")).encode("utf-8")
        toc_off = self._align()
        self._f.write(toc)
        self._f.seek(len(_MAGIC))
        self._f.write(struct.pack(_HEADER, _VERSION, 0, toc_off, len(toc)))
        self._f.close()

    def __enter__(self) -> "ColumnWriter":
        return self

    def __exit__(self, exc_type, *exc_info) -> None:
        if exc_type is None:
            self.close()
        else:  # failed write: don't persist a TOC for a truncated file
            self._f.close()


class ColumnFile:
    """mmap-backed reader for the TOC'd container — zero-copy views.

    ``array(name)`` returns the section as a read-only numpy view on the
    mapping; ``view(name, offset, shape, dtype)`` carves a typed view
    out of a blob section (how row-group matrices are read). Views
    borrow the mapping: :meth:`close` raises ``BufferError`` while any
    is live (see the module docstring's ownership rule).
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        head = self._mm[:len(_MAGIC) + struct.calcsize(_HEADER)]
        if head[:len(_MAGIC)] != _MAGIC:
            self.close()
            raise ValueError(f"{path}: not a column container (bad magic)")
        version, _, toc_off, toc_len = struct.unpack_from(
            _HEADER, head, len(_MAGIC))
        if version != _VERSION:
            self.close()
            raise ValueError(f"{path}: unsupported container version "
                             f"{version}")
        if toc_off == 0:
            self.close()
            raise ValueError(f"{path}: no TOC (writer not closed?)")
        toc = json.loads(self._mm[toc_off:toc_off + toc_len].decode("utf-8"))
        self.meta: dict[str, Any] = toc["meta"]
        self._sections: dict[str, dict[str, Any]] = {
            s["name"]: s for s in toc["sections"]}

    def section_names(self) -> list[str]:
        return list(self._sections)

    def _section(self, name: str, kind: str) -> dict[str, Any]:
        sec = self._sections.get(name)
        if sec is None or sec["kind"] != kind:
            raise KeyError(f"{self.path}: no {kind} section {name!r}")
        return sec

    def array(self, name: str) -> np.ndarray:
        sec = self._section(name, "array")
        shape = tuple(sec["shape"])
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(self._mm, np.dtype(sec["dtype"]), count,
                            sec["offset"])
        return arr.reshape(shape)

    def view(self, name: str, offset: int, shape, dtype=np.uint8
             ) -> np.ndarray:
        """Typed zero-copy view into a blob section at a relative offset."""
        sec = self._section(name, "blob")
        dtype = np.dtype(dtype)
        count = int(np.prod(shape))
        if offset < 0 or offset + count * dtype.itemsize > sec["nbytes"]:
            raise ValueError(f"view [{offset}, +{count * dtype.itemsize}) "
                             f"outside blob {name!r}")
        return np.frombuffer(self._mm, dtype, count,
                             sec["offset"] + offset).reshape(shape)

    def blob(self, name: str) -> bytes:
        """A blob section **copied out** as owning bytes (small heaps —
        URI/MIME — want bytes semantics; row-groups use :meth:`view`)."""
        sec = self._section(name, "blob")
        return self._mm[sec["offset"]:sec["offset"] + sec["nbytes"]]

    def close(self) -> None:
        """Release the mapping. Raises ``BufferError`` if zero-copy views
        handed out by :meth:`array` / :meth:`view` are still alive —
        drop or copy them first (the arena borrow rule, mmap edition).

        Views that are merely *unreachable* don't count as alive: one GC
        pass drops views held only by dead reference cycles before the
        borrow check bites.
        """
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                import gc

                gc.collect()  # drop cycle-held / deferred-freed views
                self._mm.close()  # still alive → genuinely borrowed
            self._mm = None
        self._f.close()

    def __enter__(self) -> "ColumnFile":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
