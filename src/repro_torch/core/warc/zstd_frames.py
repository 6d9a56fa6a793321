"""zstd frame-boundary walker: compressed-domain random access for zstd.

zstd frames do not carry their *compressed* length in the frame header,
which is why :class:`~repro_torch.core.warc.streams.ZstdStream` historically
decompressed a whole shard before the first random access. But the
compressed length **is** recoverable without any decompression: a frame
is ``header · block · block · … · [checksum]`` and every 3-byte block
header states its block's size, so a pure header/block walk yields every
frame's ``(compressed offset, compressed length, content size)`` at
C-of-one-pass cost (a few bytes touched per block, no entropy decode).

``repro_torch.index`` runs this walk at CDX build time and stores, per record,
the compressed offset of the frame containing it plus that frame's
decompressed base — :class:`~repro_torch.index.cdx.RandomAccessReader` then
seeks straight to the containing frame and decompresses only from there
(RFC 8878 guarantees frames are independent), instead of inflating the
shard from byte 0.

Implements the RFC 8878 framing grammar: data frames (magic
``0xFD2FB528``) and skippable frames (``0x184D2A5?``); reserved block
types and truncated structures raise ``ValueError`` rather than
guessing.
"""
from __future__ import annotations

import io
import struct
from dataclasses import dataclass

import numpy as np

__all__ = ["ZstdFrameInfo", "frame_table", "walk_frames"]

_DATA_MAGIC = 0xFD2FB528
_SKIP_MAGIC_LO = 0x184D2A50  # ..5F: skippable frame magic range
_FCS_FIELD_SIZE = (0, 2, 4, 8)   # indexed by Frame_Content_Size_flag
_DID_FIELD_SIZE = (0, 1, 2, 4)   # indexed by Dictionary_ID_flag


@dataclass
class ZstdFrameInfo:
    """One frame of a concatenated-zstd stream (compressed domain)."""

    comp_off: int            # absolute offset of the frame's magic
    comp_len: int            # full frame span, header through checksum
    content_size: int | None  # decompressed size, when the header states it
    skippable: bool = False  # skippable frames hold no stream content


def _walk_data_frame(blob, pos: int) -> tuple[int, int | None]:
    """Parse one data frame from ``pos`` (past magic is computed here);
    returns ``(end_offset, content_size_or_None)``."""
    start = pos
    pos += 4  # magic
    if pos >= len(blob):
        raise ValueError(f"truncated zstd frame header at {start}")
    fhd = blob[pos]
    pos += 1
    fcs_flag = fhd >> 6
    single_segment = (fhd >> 5) & 1
    has_checksum = (fhd >> 2) & 1
    if not single_segment:
        pos += 1  # Window_Descriptor
    pos += _DID_FIELD_SIZE[fhd & 3]
    fcs_size = _FCS_FIELD_SIZE[fcs_flag] or (1 if single_segment else 0)
    if pos + fcs_size > len(blob):
        raise ValueError(f"truncated zstd frame header at {start}")
    content_size: int | None = None
    if fcs_size:
        content_size = int.from_bytes(blob[pos:pos + fcs_size], "little")
        if fcs_size == 2:  # 2-byte field stores value - 256 (RFC 8878)
            content_size += 256
        pos += fcs_size
    while True:  # block walk: 3-byte headers state every block's span
        if pos + 3 > len(blob):
            raise ValueError(f"truncated zstd block header at {pos}")
        header = int.from_bytes(blob[pos:pos + 3], "little")
        pos += 3
        last, btype, bsize = header & 1, (header >> 1) & 3, header >> 3
        if btype == 3:
            raise ValueError(f"reserved zstd block type at {pos - 3}")
        pos += 1 if btype == 1 else bsize  # RLE stores one byte
        if last:
            break
    if has_checksum:
        pos += 4
    if pos > len(blob):
        raise ValueError(f"truncated zstd frame at {start}")
    return pos, content_size


def walk_frames(blob: bytes) -> list[ZstdFrameInfo]:
    """Frame boundaries of a concatenated-zstd blob — no decompression."""
    frames: list[ZstdFrameInfo] = []
    pos = 0
    n = len(blob)
    while pos < n:
        if pos + 4 > n:
            raise ValueError(f"trailing garbage at {pos}")
        magic = int.from_bytes(blob[pos:pos + 4], "little")
        if magic & 0xFFFFFFF0 == _SKIP_MAGIC_LO:
            if pos + 8 > n:
                raise ValueError(f"truncated skippable frame at {pos}")
            (size,) = struct.unpack_from("<I", blob, pos + 4)
            end = pos + 8 + size
            if end > n:
                raise ValueError(f"truncated skippable frame at {pos}")
            frames.append(ZstdFrameInfo(pos, end - pos, 0, skippable=True))
        elif magic == _DATA_MAGIC:
            end, content_size = _walk_data_frame(blob, pos)
            frames.append(ZstdFrameInfo(pos, end - pos, content_size))
        else:
            raise ValueError(f"bad zstd frame magic at {pos}: {magic:#x}")
        pos = end
    return frames


def _measure(blob, frame: ZstdFrameInfo) -> int:
    """Decompressed size of one frame whose header omits it."""
    try:
        import zstandard as _zstd
    except ImportError as exc:
        raise RuntimeError("zstandard needed to size a frame without "
                           "Frame_Content_Size") from exc
    reader = _zstd.ZstdDecompressor().stream_reader(
        io.BytesIO(bytes(blob[frame.comp_off:frame.comp_off + frame.comp_len])))
    total = 0
    while True:
        chunk = reader.read(1 << 20)
        if not chunk:
            return total
        total += len(chunk)


def frame_table(blob: bytes) -> tuple[np.ndarray, np.ndarray]:
    """``(comp_offs, decomp_bases)`` of the *data* frames of a blob.

    ``decomp_bases[i]`` is the decompressed-stream offset where data
    frame ``i`` begins — ``searchsorted`` against it maps any record's
    decompressed offset to its containing frame. Headers lacking
    ``Frame_Content_Size`` fall back to decompressing that one frame to
    measure it (our writer always stores the size, so the common path
    never decompresses anything).
    """
    comp_offs: list[int] = []
    sizes: list[int] = []
    for frame in walk_frames(blob):
        if frame.skippable:
            continue
        comp_offs.append(frame.comp_off)
        sizes.append(frame.content_size if frame.content_size is not None
                     else _measure(blob, frame))
    bases = np.zeros(len(sizes), np.uint64)
    if len(sizes) > 1:
        bases[1:] = np.cumsum(np.asarray(sizes[:-1], np.uint64))
    return np.asarray(comp_offs, np.uint64), bases
