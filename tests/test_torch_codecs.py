"""Codec slice parity: xxh32, the LZ4 block and frame codec, zstd frame
walking, the writer and recompressor, the FastWARC-style iterator over
every codec and source kind, and the WARCIO baseline.

The port (``repro_torch.core.warc``) and the reference
(``repro.core.warc``) run on the same seeded inputs; every output is
bit-identical: hashes, compressed bytes, frame tables, WARC images, and
each record's offset, type, headers, content, HTTP headers, digest checks
and the iterator's ``records_skipped``. Corpora are small (LZ4 is pure
Python in both packages), and each test runs under its own alarm.
"""
import io
import signal
import zlib

import numpy as np
import pytest

import repro.core.warc as RW
from repro.core.warc import lz4 as R_lz4
from repro.core.warc import xxh32 as R_xxh
from repro.core.warc import zstd_frames as R_zf
from repro.data.synth import CorpusSpec as RSpec
from repro.data.synth import generate_warc as r_generate

import repro_torch.core.warc as PW
from repro_torch.core.warc import lz4 as P_lz4
from repro_torch.core.warc import xxh32 as P_xxh
from repro_torch.core.warc import zstd_frames as P_zf
from repro_torch.data.synth import CorpusSpec, generate_warc

zstd = pytest.importorskip("zstandard")

CODECS = ("none", "gzip", "lz4", "zstd")
SPEC = CorpusSpec(n_pages=12, seed=21, html_words_lo=30, html_words_hi=900)
DEADLINE_S = 60


@pytest.fixture(autouse=True)
def deadline():
    def expire(signum, frame):
        raise TimeoutError(f"codec test still running after {DEADLINE_S} s")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


def _payloads(seed: int) -> list[bytes]:
    """Random, repetitive and text-like byte strings of awkward sizes."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9)).astype(np.uint8))
             for _ in range(40)]
    out = [b"", b"a", b"abcd" * 3, bytes(13), b"x" * 70_000]
    for n in (5, 12, 13, 64, 255, 4096, 65_535, 65_536, 200_003):
        out.append(bytes(rng.integers(0, 256, n).astype(np.uint8)))
        text = b" ".join(words[i] for i in rng.integers(0, 40, n // 4 + 1))
        out.append(text[:n])
    return out


def _record_key(r) -> tuple:
    http = r.http_headers
    return (r.stream_offset, int(r.record_type), r.headers.status_line,
            r.headers.items_bytes(), bytes(r.content),
            None if http is None else (http.status_line, http.items_bytes()),
            r.http_content_offset, r.verified_block_digest,
            r.verified_payload_digest)


def _sweep(mod, source, **kw):
    it = mod.FastWARCIterator(source, **kw)
    recs = [_record_key(r) for r in it]
    return recs, it.records_skipped, it.records_yielded


def test_xxh32_and_lz4_block_codec_match_reference():
    for seed in (0, 0x9E3779B1, 7):
        for data in _payloads(1):
            assert P_xxh.xxh32(data, seed) == R_xxh.xxh32(data, seed)
    for data in _payloads(2):
        block = P_lz4.compress_block(data)
        assert block == R_lz4.compress_block(data)
        assert P_lz4.decompress_block(block) == data
        assert R_lz4.decompress_block(block) == data
        out = bytearray(b"prefix")
        n = P_lz4.decompress_block_into(block, out)
        assert (n, bytes(out)) == (len(data), b"prefix" + data)
    # a truncated block fails the same way in both packages
    bad = P_lz4.compress_block(b"abcdefgh" * 50)[:-3]
    for mod in (P_lz4, R_lz4):
        with pytest.raises(mod.LZ4Error):
            mod.decompress_block(bad)


def test_lz4_frame_codec_matches_reference():
    for i, data in enumerate(_payloads(3)):
        for kw in ({}, {"content_checksum": True},
                   {"block_size_code": 4}, {"store_content_size": False}):
            frame = P_lz4.compress_frame(data, **kw)
            assert frame == R_lz4.compress_frame(data, **kw)
            buf = b"junk" + frame + b"tail"
            got, end = P_lz4.decompress_frame(buf, 4, verify_checksum=True)
            assert (got, end) == R_lz4.decompress_frame(
                buf, 4, verify_checksum=True)
            assert got == data and end == 4 + len(frame)
            assert P_lz4.skip_frame(buf, 4) == R_lz4.skip_frame(buf, 4) == end
            out = bytearray()
            assert P_lz4.decompress_frame_into(buf, 4, out) == \
                (len(data), end)
            assert bytes(out) == data
            assert [getattr(P_lz4.parse_frame_header(buf, 4), a)
                    for a in R_lz4.FrameInfo.__slots__] == \
                [getattr(R_lz4.parse_frame_header(buf, 4), a)
                 for a in R_lz4.FrameInfo.__slots__]
    corrupt = bytearray(P_lz4.compress_frame(b"hello world" * 9,
                                             content_checksum=True))
    corrupt[-2] ^= 0xFF
    for mod in (P_lz4, R_lz4):
        with pytest.raises(mod.LZ4Error):
            mod.decompress_frame(bytes(corrupt), 0, verify_checksum=True)


def test_generate_warc_bytes_every_codec():
    for seed in (21, 22):
        spec = CorpusSpec(n_pages=6, seed=seed)
        for comp in CODECS:
            assert generate_warc(spec, comp) == r_generate(
                RSpec(n_pages=6, seed=seed), comp), comp


def test_recompress_matches_reference(tmp_path):
    src = tmp_path / "a.warc.gz"
    src.write_bytes(generate_warc(SPEC, "gzip"))
    for comp in ("lz4", "zstd", "none"):
        pst = PW.recompress(str(src), str(tmp_path / f"p.{comp}"), comp)
        rst = RW.recompress(str(src), str(tmp_path / f"r.{comp}"), comp)
        assert pst == rst
        got = (tmp_path / f"p.{comp}").read_bytes()
        assert got == (tmp_path / f"r.{comp}").read_bytes()
        assert got == generate_warc(SPEC, comp)  # the records, verbatim


def test_frame_table_matches_reference():
    blob = generate_warc(SPEC, "zstd")
    # a skippable frame in the middle, and one frame without its content
    # size (the walk then decompresses that frame to measure it)
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"abcde"
    no_size = zstd.ZstdCompressor(write_content_size=False).compress(
        b"WARC/1.1\r\nContent-Length: 0\r\n\r\n\r\n\r\n")
    for data in (blob, blob[:len(blob) // 2] + skip, blob + no_size + skip):
        try:
            want = R_zf.frame_table(data)
        except ValueError as exc:
            with pytest.raises(ValueError, match=str(exc)[:20]):
                P_zf.frame_table(data)
            continue
        got = P_zf.frame_table(data)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.uint64
            np.testing.assert_array_equal(a, b)
        assert [vars(f) for f in P_zf.walk_frames(data)] == \
            [vars(f) for f in R_zf.walk_frames(data)]
    for bad in (blob[:3], b"\x00" * 8, blob[:-1]):
        with pytest.raises(ValueError):
            R_zf.walk_frames(bad)
        with pytest.raises(ValueError):
            P_zf.walk_frames(bad)


@pytest.mark.parametrize("comp", CODECS)
def test_fastwarc_records_match_reference(comp, tmp_path):
    data = generate_warc(SPEC, comp)
    path = tmp_path / f"c.{comp}"
    path.write_bytes(data)
    # a predicate on the parsed record, the same in both packages
    def pick(r):
        return r.content_length % 3 != 0

    for types in ("any", "response", "filter"):
        for src in (data, str(path)):
            kw_p, kw_r = {}, {}
            if types == "response":
                kw_p["record_types"] = PW.WarcRecordType.response
                kw_r["record_types"] = RW.WarcRecordType.response
            elif types == "filter":
                kw_p["func_filter"] = kw_r["func_filter"] = pick
            for extra in ({}, {"parse_http": False, "verify_digests": True}):
                got = _sweep(PW, src, **kw_p, **extra)
                want = _sweep(RW, src, **kw_r, **extra)
                assert got == want, (comp, types, type(src), extra)
                assert got[1] + got[2] == 37 or types == "any"
    # readahead forced on the filtered LZ4 path, and off everywhere
    for ra in (True, False):
        got = _sweep(PW, str(path), readahead=ra,
                     record_types=PW.WarcRecordType.response)
        assert got == _sweep(RW, str(path), readahead=ra,
                             record_types=RW.WarcRecordType.response)


def test_read_record_at_and_header_blocks(tmp_path):
    for comp in ("lz4", "gzip", "none"):
        data = generate_warc(SPEC, comp)
        offsets = [r.stream_offset for r in PW.FastWARCIterator(data)]
        for off in offsets[::5]:
            got = PW.read_record_at(io.BytesIO(data), off)
            want = RW.read_record_at(io.BytesIO(data), off)
            assert _record_key(got) == _record_key(want)
        # an offset inside a record: the same record or the same error
        # (a gzip member cut open decodes to nothing)
        outcome = []
        for mod in (PW, RW):
            try:
                outcome.append(_record_key(mod.read_record_at(
                    io.BytesIO(data), offsets[1] + 1)))
            except mod.RecordReadError as exc:
                outcome.append(str(exc))
        assert outcome[0] == outcome[1]
    block = (b"WARC/1.1\r\nWARC-Type: response\r\nX-Folded: a\r\n b\r\n"
             b"Bad line\r\nContent-Length:   12 \r\nEmpty:")
    assert PW.parse_header_block(block).items_bytes() == \
        RW.parse_header_block(block).items_bytes()
    assert PW.parse_header_block(memoryview(block)).status_line == b"WARC/1.1"


def test_warcio_baseline_matches_reference(tmp_path):
    def key(r):
        http = r.http_headers
        return (r.headers, r.rec_type, r.content, r.http_body_offset,
                None if http is None else http.items_bytes(),
                r.digest_ok, r.payload_digest_ok, r.record_id, r.target_uri)

    for comp in ("none", "gzip"):
        data = generate_warc(SPEC, comp)
        path = tmp_path / f"w.{comp}"
        path.write_bytes(data)
        for src in (data, str(path)):
            for kw in ({}, {"parse_http": True, "verify_digests": True}):
                got = [key(r) for r in PW.WARCIOArchiveIterator(src, **kw)]
                want = [key(r) for r in RW.WARCIOArchiveIterator(src, **kw)]
                assert got == want and len(got) == 37
                assert [(t, len(c)) for _, t, c, *_ in got] == \
                    [(r.record_type.name, r.content_length)
                     for r in PW.FastWARCIterator(src)]
    # the baseline, like the paper's WARCIO, takes neither zstd nor LZ4
    for comp in ("zstd", "lz4"):
        data = generate_warc(SPEC, comp)
        errs = []
        for mod in (PW, RW):
            with pytest.raises(Exception) as exc:
                list(mod.WARCIOArchiveIterator(data))
            errs.append((type(exc.value).__name__, str(exc.value)))
        assert errs[0] == errs[1]
    # the baseline's chunked gzip reader across a member boundary
    from repro_torch.core.warc.streams import ChunkedGzipReader

    co = zlib.compressobj(6, zlib.DEFLATED, 31)
    member = co.compress(b"line one\nline two\n" * 3000) + co.flush()
    reader = ChunkedGzipReader(io.BytesIO(member * 2))
    assert reader.readline() == b"line one\n"
    assert reader.read() == (b"line one\nline two\n" * 6000)[9:]
