"""Pattern-scan kernel: CUDA launches, plain PyTorch versions, launch counts.

For a pattern ``p`` of length P ≤ 16 the match mask of a padded byte
matrix is ``mask[r, i] = AND_{j<P} buf[r, i + j] == p[j]``. Rows carry a
zero tail, so every window starting in a row is in bounds and no halo
input is needed (the Pallas kernel's halo existed only because its
BlockSpecs could not overlap). Two layouts and two pattern forms, one
CUDA source:

* batches, ``(B, W + MAX_PATTERN)``: :func:`pattern_scan_batch`, plain
  version :func:`pattern_scan_plain`, counted in ``launches``;
* row-groups of the columnar store, ``(B, W + ROWGROUP_PAD)``:
  :func:`pattern_scan_rowgroup`, plain version
  :func:`pattern_scan_rowgroup_plain`, counted in ``rowgroup_launches``;
* one pattern **per row** (the gateway's cross-request batching): a
  ``(B, MAX_PATTERN)`` uint8 pattern matrix and ``(B,)`` int32 lengths;
  positions at or past a row's own length always match.
  :func:`pattern_scan_batch_multi` / :func:`pattern_scan_rowgroup_multi`,
  plain versions :func:`pattern_scan_multi_plain` /
  :func:`pattern_scan_rowgroup_multi_plain`, counted in
  ``multi_launches`` / ``rowgroup_multi_launches``.

The batch forms launch in **groups**: the width buckets of one wrapper
call, packed at 16-byte-aligned offsets of one byte buffer (for the
multi form each bucket's patterns and lengths beside its matrix), with a
descriptor table (:data:`GROUP_DTYPE`, one entry per bucket: offsets,
rows, width, loop bound). :func:`pattern_scan_group` and
:func:`pattern_scan_multi_group` sweep a group in one launch for every
:data:`MAX_GROUP` entries; :func:`pattern_scan_batch` and
:func:`pattern_scan_batch_multi` are one-entry groups over one matrix.

Each entry point launches ``csrc/pattern_scan.cu`` for a CUDA tensor and
uses its plain version for a CPU tensor (a group entry by entry); any
other device raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels.bucketing import ROWGROUP_PAD

__all__ = ["DEFAULT_BLOCK", "GROUP_DTYPE", "MAX_GROUP", "MAX_PATTERN",
           "group_layout", "group_views", "launches", "multi_launches",
           "pattern_scan_batch", "pattern_scan_batch_multi",
           "pattern_scan_group", "pattern_scan_multi_group",
           "pattern_scan_multi_plain", "pattern_scan_plain",
           "pattern_scan_rowgroup", "pattern_scan_rowgroup_multi",
           "pattern_scan_rowgroup_multi_plain", "pattern_scan_rowgroup_plain",
           "rowgroup_launches", "rowgroup_multi_launches"]

DEFAULT_BLOCK = 64 * 1024  # width-bucket granularity of whole-buffer scans
MAX_PATTERN = 16           # longest pattern; also each batch row's zero tail
MAX_GROUP = 64             # table entries one launch takes
ALIGN = 16                 # byte alignment of every matrix, pattern and mask

# one width bucket of a group; the layout of ``Desc`` in
# csrc/pattern_scan.cu. Offsets are in bytes: in_off of the (rows, width +
# MAX_PATTERN) matrix in the input buffer, mask_off of the (rows, width)
# mask in the mask buffer, and for the multi form pat_off and len_off of
# the (rows, MAX_PATTERN) patterns and (rows,) int32 lengths; max_len is
# the multi form's loop bound. The launcher fills first, parts and shift
# (the entry's block geometry) in its own copy.
GROUP_DTYPE = np.dtype([("in_off", "<i8"), ("mask_off", "<i8"),
                        ("pat_off", "<i8"), ("len_off", "<i8"),
                        ("rows", "<i4"), ("width", "<i4"),
                        ("max_len", "<i4"), ("first", "<i4"),
                        ("parts", "<i4"), ("shift", "<i4")])

launches = 0           # CUDA launches of pattern_scan_group in this process
rowgroup_launches = 0  # CUDA launches of pattern_scan_rowgroup
multi_launches = 0     # CUDA launches of pattern_scan_multi_group
rowgroup_multi_launches = 0  # CUDA launches of pattern_scan_rowgroup_multi


def _check_pattern_vec(pattern: np.ndarray, pat_len: int) -> None:
    if pattern.dtype != np.uint8 or pattern.shape != (MAX_PATTERN,):
        raise ValueError(f"pattern must be a ({MAX_PATTERN},) uint8 array")
    if not 0 < pat_len <= MAX_PATTERN:
        raise ValueError(f"pat_len must be in [1, {MAX_PATTERN}]")


def _check(padded: torch.Tensor, pattern: np.ndarray, pat_len: int,
           tail: int) -> int:
    """Validate the kernel's inputs; returns the scanned width W."""
    if padded.dtype != torch.uint8 or padded.dim() != 2:
        raise ValueError("padded must be a 2-D uint8 tensor")
    width = padded.shape[1] - tail
    if width <= 0 or width % 16:
        raise ValueError(f"padded width {padded.shape[1]} must be "
                         f"{tail} plus a positive multiple of 16")
    _check_pattern_vec(pattern, pat_len)
    return width


def _plain(padded: torch.Tensor, pattern: np.ndarray, pat_len: int,
           width: int) -> torch.Tensor:
    """P shifted compares over the whole matrix."""
    acc = padded[:, :width] == int(pattern[0])
    for j in range(1, pat_len):
        acc &= padded[:, j:j + width] == int(pattern[j])
    return acc.to(torch.uint8)


def pattern_scan_plain(padded: torch.Tensor, pattern: np.ndarray,
                       pat_len: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`pattern_scan_batch`."""
    width = _check(padded, pattern, pat_len, MAX_PATTERN)
    return _plain(padded, pattern, pat_len, width)


def pattern_scan_rowgroup_plain(matrix: torch.Tensor, pattern: np.ndarray,
                                pat_len: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`pattern_scan_rowgroup`."""
    width = _check(matrix, pattern, pat_len, ROWGROUP_PAD)
    return _plain(matrix, pattern, pat_len, width)


_ARGTYPES = {  # after (buf, mask); every entry ends with the stream
    "pattern_scan_group": [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
                           ctypes.c_uint64, ctypes.c_int],
    "pattern_scan_multi_group": [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int],
    "pattern_scan_rowgroup": [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int],
    "pattern_scan_rowgroup_multi": [ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int],
}


@functools.cache
def _entry(entry: str) -> ctypes._CFuncPtr:
    """The C entry point ``entry`` of ``pattern_scan.cu``, resolved and
    typed once per process."""
    from repro_torch.kernels._build import library

    fn = getattr(library("pattern_scan"), entry)
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + _ARGTYPES[entry]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _call(entry: str, device: torch.device, *args) -> None:
    """Call ``entry`` on ``device``'s current stream; raise on an error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(entry)(*args, stream)
    if err:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def _words(pattern: np.ndarray) -> tuple[int, int]:
    """The pattern's bytes 0-7 and 8-15 as little-endian words."""
    return (int.from_bytes(pattern[:8].tobytes(), "little"),
            int.from_bytes(pattern[8:].tobytes(), "little"))


# -- grouped batch launches ---------------------------------------------------

def _align(x: int) -> int:
    return -(-x // ALIGN) * ALIGN


def group_layout(shapes, *, multi: bool = False
                 ) -> tuple[np.ndarray, int, int]:
    """Descriptor table of a group of batch matrices, packed in order.

    ``shapes`` is a sequence of ``(rows, width, max_len)``; matrix ``i``
    is ``(rows, width + MAX_PATTERN)`` uint8 and, when ``multi``, its
    ``(rows, MAX_PATTERN)`` patterns and ``(rows,)`` int32 lengths follow
    it in the same buffer. Returns ``(table, in_bytes, mask_bytes)``: the
    :data:`GROUP_DTYPE` table and the sizes of the input and mask
    buffers. Everything starts 16-byte aligned, and no two spans overlap.
    """
    table = np.zeros(len(shapes), GROUP_DTYPE)
    in_off = mask_off = 0
    for e, (rows, width, max_len) in zip(table, shapes):
        if not (0 < width < 1 << 31 and width % 16 == 0
                and 0 <= rows < 1 << 31 and 0 < max_len <= MAX_PATTERN):
            raise ValueError(f"matrix ({rows}, {width}) with max_len "
                             f"{max_len} does not fit the kernel's table")
        e["in_off"] = in_off
        in_off += _align(rows * (width + MAX_PATTERN))
        if multi:
            e["pat_off"] = in_off
            in_off += _align(rows * MAX_PATTERN)
            e["len_off"] = in_off
            in_off += _align(4 * rows)
        e["mask_off"] = mask_off
        mask_off += _align(rows * width)
        e["rows"], e["width"], e["max_len"] = rows, width, max_len
    return table, in_off, mask_off


def group_views(mask: torch.Tensor | np.ndarray, table: np.ndarray):
    """The ``(rows, width)`` mask of each table entry, as views of
    ``mask``."""
    return [mask[int(e["mask_off"]):int(e["mask_off"])
                 + int(e["rows"]) * int(e["width"])].reshape(
                     int(e["rows"]), int(e["width"])) for e in table]


def _matrix(buf: torch.Tensor, e) -> torch.Tensor:
    rows, width = int(e["rows"]), int(e["width"])
    off = int(e["in_off"])
    return buf[off:off + rows * (width + MAX_PATTERN)].reshape(
        rows, width + MAX_PATTERN)


def _check_group(buf: torch.Tensor, table: np.ndarray, mask: torch.Tensor,
                 pats: torch.Tensor | None = None,
                 lens: torch.Tensor | None = None) -> None:
    tensors = {"buf": buf, "mask": mask}
    if pats is not None:
        tensors.update(pats=pats, lens=lens)
    for name, t in tensors.items():
        if t.dtype != torch.uint8 or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D uint8 tensor")
        if t.device != buf.device:
            raise ValueError(f"{name} and buf must share a device")
    if table.dtype != GROUP_DTYPE or table.ndim != 1:
        raise ValueError("table must be a 1-D GROUP_DTYPE array")
    for e in table:
        rows, width = int(e["rows"]), int(e["width"])
        if rows < 0 or width <= 0 or width % 16:
            raise ValueError(f"width {width} must be a positive multiple "
                             f"of 16, rows {rows} at least 0")
        spans = [(int(e["in_off"]), rows * (width + MAX_PATTERN), buf, ALIGN),
                 (int(e["mask_off"]), rows * width, mask, ALIGN)]
        if pats is not None:
            if not 0 < int(e["max_len"]) <= MAX_PATTERN:
                raise ValueError(f"max_len must be in [1, {MAX_PATTERN}]")
            spans += [(int(e["pat_off"]), rows * MAX_PATTERN, pats, ALIGN),
                      (int(e["len_off"]), 4 * rows, lens, 4)]
        for off, size, t, align in spans:
            if off < 0 or off % align or off + size > t.numel():
                raise ValueError("table entry outside its buffer or "
                                 "misaligned")


def _slices(table: np.ndarray):
    """The table in launches of at most :data:`MAX_GROUP` entries."""
    for start in range(0, table.size, MAX_GROUP):
        yield np.ascontiguousarray(table[start:start + MAX_GROUP])


def _launch_group(entry: str, buf: torch.Tensor, table: np.ndarray,
                  mask: torch.Tensor, *, ptrs=(), scalars=()) -> int:
    """Launch ``entry`` once per :data:`MAX_GROUP` entries of ``table``
    that hold a row, with ``ptrs`` between the mask and the table and
    ``scalars`` after the entry count; returns the launches made."""
    for name, t in (("buf", buf), ("mask", mask)):
        if not t.is_contiguous() or t.data_ptr() % ALIGN:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    made = 0
    for part in _slices(table):
        if not part["rows"].any():
            continue  # the kernel would launch no block
        _call(entry, buf.device, buf.data_ptr(), mask.data_ptr(), *ptrs,
              part.ctypes.data, part.size, *scalars)
        made += 1
    return made


def pattern_scan_group(buf: torch.Tensor, table: np.ndarray,
                       mask: torch.Tensor, pattern: np.ndarray,
                       pat_len: int) -> None:
    """Scan every matrix of a group for one pattern into ``mask``.

    ``buf`` is a 1-D uint8 tensor holding each ``table`` entry's
    ``(rows, width + MAX_PATTERN)`` matrix at its ``in_off``; ``mask`` a
    1-D uint8 tensor on the same device that receives each entry's
    ``(rows, width)`` mask at its ``mask_off`` (:func:`group_layout`
    builds a table, :func:`group_views` reads the masks). On a CUDA
    tensor one kernel launch sweeps up to :data:`MAX_GROUP` entries; on
    a CPU tensor each entry goes through :func:`pattern_scan_plain`.
    """
    _check_pattern_vec(pattern, pat_len)
    _check_group(buf, table, mask)
    if buf.device.type == "cuda":
        global launches
        launches += _launch_group("pattern_scan_group", buf, table, mask,
                                  scalars=(*_words(pattern), pat_len))
        return
    if buf.device.type != "cpu":
        raise ValueError(f"unsupported device {buf.device}")
    for part in _slices(table):
        for e, out in zip(part, group_views(mask, part)):
            out.copy_(_plain(_matrix(buf, e), pattern, pat_len,
                             int(e["width"])))


def pattern_scan_multi_group(buf: torch.Tensor, table: np.ndarray,
                             mask: torch.Tensor, *,
                             pats: torch.Tensor | None = None,
                             lens: torch.Tensor | None = None) -> None:
    """Scan every matrix of a group, each row for its own pattern.

    As :func:`pattern_scan_group`, with row ``r`` of an entry scanned for
    the pattern at ``pats[pat_off + 16 r:][:16]`` (zero-padded) of the
    int32 length at ``lens[len_off + 4 r:][:4]``, the compare loop
    bounded by the entry's ``max_len``. ``pats`` and ``lens`` are 1-D
    uint8 tensors, ``buf`` itself when omitted (the staging layout of
    :func:`group_layout` with ``multi=True``). Each entry's plain version
    is :func:`pattern_scan_multi_plain`.
    """
    pats = buf if pats is None else pats
    lens = buf if lens is None else lens
    _check_group(buf, table, mask, pats, lens)
    if buf.device.type == "cuda":
        if not pats.is_contiguous() or pats.data_ptr() % ALIGN:
            raise ValueError("pats must be contiguous and 16-byte aligned")
        if not lens.is_contiguous() or lens.data_ptr() % 4:
            raise ValueError("lens must be contiguous and 4-byte aligned")
        global multi_launches
        multi_launches += _launch_group(
            "pattern_scan_multi_group", buf, table, mask,
            ptrs=(pats.data_ptr(), lens.data_ptr()))
        return
    if buf.device.type != "cpu":
        raise ValueError(f"unsupported device {buf.device}")
    for part in _slices(table):
        for e, out in zip(part, group_views(mask, part)):
            rows, poff, loff = (int(e["rows"]), int(e["pat_off"]),
                                int(e["len_off"]))
            out.copy_(_plain_multi(
                _matrix(buf, e),
                pats[poff:poff + rows * MAX_PATTERN].reshape(rows,
                                                             MAX_PATTERN),
                lens[loff:loff + 4 * rows].view(torch.int32),
                int(e["max_len"]), int(e["width"])))


def pattern_scan_batch(padded: torch.Tensor, pattern: np.ndarray,
                       pat_len: int) -> torch.Tensor:
    """Match mask over a padded byte matrix — one launch for the batch.

    ``padded`` is ``(B, W + MAX_PATTERN)`` uint8 with ``W % 16 == 0`` and
    a zero tail; ``pattern`` is the ``(MAX_PATTERN,)`` zero-padded
    pattern, ``pat_len`` its true length. Returns the ``(B, W)`` uint8
    mask on ``padded``'s device: a one-entry :func:`pattern_scan_group`.
    """
    width = _check(padded, pattern, pat_len, MAX_PATTERN)
    table, _, nmask = group_layout([(padded.shape[0], width, pat_len)])
    mask = torch.empty(nmask, dtype=torch.uint8, device=padded.device)
    pattern_scan_group(padded.reshape(-1), table, mask, pattern, pat_len)
    return group_views(mask, table)[0]


def pattern_scan_rowgroup(matrix: torch.Tensor, pattern: np.ndarray,
                          pat_len: int) -> torch.Tensor:
    """Match mask over a packed row-group matrix — one launch.

    ``matrix`` is ``(B, W + ROWGROUP_PAD)`` uint8 in the columnar store's
    row-group layout (payload left-justified, zero tail; ``W % 16 == 0``);
    ``pattern`` and ``pat_len`` as in :func:`pattern_scan_batch`. Returns
    the ``(B, W)`` uint8 mask on ``matrix``'s device; positions past each
    row's true length are the caller's to trim.
    """
    width = _check(matrix, pattern, pat_len, ROWGROUP_PAD)
    if matrix.device.type == "cpu":
        return _plain(matrix, pattern, pat_len, width)
    if matrix.device.type != "cuda":
        raise ValueError(f"unsupported device {matrix.device}")
    if not matrix.is_contiguous() or matrix.data_ptr() % ALIGN:
        raise ValueError("padded must be contiguous and 16-byte aligned")
    rows = matrix.shape[0]
    mask = torch.empty((rows, width), dtype=torch.uint8, device=matrix.device)
    _call("pattern_scan_rowgroup", matrix.device, matrix.data_ptr(),
          mask.data_ptr(), rows, width, matrix.shape[1], *_words(pattern),
          pat_len)
    global rowgroup_launches
    rowgroup_launches += 1
    return mask


# -- one pattern per row ------------------------------------------------------

def _check_multi(padded: torch.Tensor, pattern_mat: torch.Tensor,
                 pat_lens: torch.Tensor, max_len: int, tail: int) -> int:
    """Validate the multi-pattern kernel's inputs; returns the width W."""
    if padded.dtype != torch.uint8 or padded.dim() != 2:
        raise ValueError("padded must be a 2-D uint8 tensor")
    rows = padded.shape[0]
    width = padded.shape[1] - tail
    if width <= 0 or width % 16:
        raise ValueError(f"padded width {padded.shape[1]} must be "
                         f"{tail} plus a positive multiple of 16")
    if (pattern_mat.dtype != torch.uint8
            or tuple(pattern_mat.shape) != (rows, MAX_PATTERN)):
        raise ValueError(f"pattern_mat must be a ({rows}, {MAX_PATTERN}) "
                         f"uint8 tensor")
    if pat_lens.dtype != torch.int32 or tuple(pat_lens.shape) != (rows,):
        raise ValueError(f"pat_lens must be a ({rows},) int32 tensor")
    if not (padded.device == pattern_mat.device == pat_lens.device):
        raise ValueError("padded, pattern_mat and pat_lens must share a "
                         "device")
    if not 0 < max_len <= MAX_PATTERN:
        raise ValueError(f"max_len must be in [1, {MAX_PATTERN}]")
    return width


def _plain_multi(padded: torch.Tensor, pattern_mat: torch.Tensor,
                 pat_lens: torch.Tensor, max_len: int,
                 width: int) -> torch.Tensor:
    """``max_len`` shifted compares; position j >= 1 forced to match on
    rows whose pattern is shorter than j + 1 (the lengths are not read
    back from the device, so any value is defined: position 0 is always
    compared)."""
    acc = padded[:, :width] == pattern_mat[:, 0:1]
    lens = pat_lens.reshape(-1, 1)
    for j in range(1, max_len):
        acc &= (padded[:, j:j + width] == pattern_mat[:, j:j + 1]) | (j >= lens)
    return acc.to(torch.uint8)


def pattern_scan_multi_plain(padded: torch.Tensor, pattern_mat: torch.Tensor,
                             pat_lens: torch.Tensor,
                             max_len: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`pattern_scan_batch_multi`."""
    width = _check_multi(padded, pattern_mat, pat_lens, max_len, MAX_PATTERN)
    return _plain_multi(padded, pattern_mat, pat_lens, max_len, width)


def pattern_scan_rowgroup_multi_plain(matrix: torch.Tensor,
                                      pattern_mat: torch.Tensor,
                                      pat_lens: torch.Tensor,
                                      max_len: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`pattern_scan_rowgroup_multi`."""
    width = _check_multi(matrix, pattern_mat, pat_lens, max_len, ROWGROUP_PAD)
    return _plain_multi(matrix, pattern_mat, pat_lens, max_len, width)


def pattern_scan_batch_multi(padded: torch.Tensor, pattern_mat: torch.Tensor,
                             pat_lens: torch.Tensor,
                             max_len: int) -> torch.Tensor:
    """Per-row-pattern match masks — **one** launch for a mixed batch.

    ``padded`` is ``(B, W + MAX_PATTERN)`` uint8 as in
    :func:`pattern_scan_batch`; row ``r`` is scanned for
    ``pattern_mat[r, :pat_lens[r]]`` (``pattern_mat`` ``(B, MAX_PATTERN)``
    uint8 zero-padded, ``pat_lens`` ``(B,)`` int32, all on ``padded``'s
    device). ``max_len`` bounds the compare loop (the longest length);
    the caller keeps every length in ``[1, max_len]``.
    Returns the ``(B, W)`` uint8 mask on ``padded``'s device: a one-entry
    :func:`pattern_scan_multi_group` whose patterns and lengths are
    their own tensors.
    """
    width = _check_multi(padded, pattern_mat, pat_lens, max_len, MAX_PATTERN)
    table, _, nmask = group_layout([(padded.shape[0], width, max_len)],
                                   multi=True)
    table["pat_off"] = table["len_off"] = 0
    mask = torch.empty(nmask, dtype=torch.uint8, device=padded.device)
    pattern_scan_multi_group(padded.reshape(-1), table, mask,
                             pats=pattern_mat.reshape(-1),
                             lens=pat_lens.reshape(-1).view(torch.uint8))
    return group_views(mask, table)[0]


def pattern_scan_rowgroup_multi(matrix: torch.Tensor,
                                pattern_mat: torch.Tensor,
                                pat_lens: torch.Tensor,
                                max_len: int) -> torch.Tensor:
    """Per-row-pattern match masks over a packed row-group — one launch.

    ``matrix`` is ``(B, W + ROWGROUP_PAD)`` uint8 in the row-group layout;
    the patterns as in :func:`pattern_scan_batch_multi`. Returns the
    ``(B, W)`` uint8 mask on ``matrix``'s device; positions past each
    row's true length are the caller's to trim.
    """
    width = _check_multi(matrix, pattern_mat, pat_lens, max_len, ROWGROUP_PAD)
    if matrix.device.type == "cpu":
        return _plain_multi(matrix, pattern_mat, pat_lens, max_len, width)
    if matrix.device.type != "cuda":
        raise ValueError(f"unsupported device {matrix.device}")
    for name, t in (("padded", matrix), ("pattern_mat", pattern_mat)):
        if not t.is_contiguous() or t.data_ptr() % ALIGN:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if not pat_lens.is_contiguous():
        raise ValueError("pat_lens must be contiguous")
    rows = matrix.shape[0]
    mask = torch.empty((rows, width), dtype=torch.uint8, device=matrix.device)
    _call("pattern_scan_rowgroup_multi", matrix.device, matrix.data_ptr(),
          mask.data_ptr(), rows, width, matrix.shape[1],
          pattern_mat.data_ptr(), pat_lens.data_ptr(), max_len)
    global rowgroup_multi_launches
    rowgroup_multi_launches += 1
    return mask
