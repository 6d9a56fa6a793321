"""Readahead and tolerant-parsing slice: the child-process member decoder
(``ProcessReadaheadDecoder``), its supervision, and the recovering parser
through ``FastWARCIterator``, ``build_index`` and ``derive``.

The process decoder yields the thread decoder's and the reference's
records; ``close()`` reaps the child and unlinks its ring segment; a
decoder child stalled by ``arm_decoder_stall`` is respawned and the
records stay the reference's; a daemonic parent takes the thread
decoder. ``corrupt_warc`` damages gzip, LZ4 and uncompressed images the
same way in both packages, and the tolerant parser — serial, on a
thread, in a child process — gives the reference's survivors and
``ErrorLedger`` entries, as do ``build_index(tolerant=True)`` and
``derive(tolerant=True)``.

Every test runs under its own alarm and leaves no ``/dev/shm`` segment
of this process behind.
"""
import glob
import io
import multiprocessing as mp
import os
import signal
import zlib

import numpy as np
import pytest

import repro.core.warc as RW
import repro.testing.faults as RF

import repro_torch.core.warc as PW
import repro_torch.testing.faults as PF
from repro_torch import obs
from repro_torch.columnar import derive
from repro_torch.core.reaper import SHM_PREFIX
from repro_torch.core.warc.streams import DECODER_STALL_S_ENV
from repro_torch.data.synth import CorpusSpec, generate_warc
from repro_torch.index import build_index

SPEC = CorpusSpec(n_pages=20, seed=8, html_words_lo=30, html_words_hi=900)
COLUMNS = ("shard_id", "offset", "comp_len", "uncomp_len", "rtype", "status",
           "digest", "signatures", "frame_off", "frame_base", "uri_off",
           "mime_off")
DEADLINE_S = 45


def _segments() -> list:
    return glob.glob(f"/dev/shm/{SHM_PREFIX}-{os.getpid()}-*")


@pytest.fixture(autouse=True)
def deadline():
    def expire(signum, frame):
        raise TimeoutError(f"readahead test still running after "
                           f"{DEADLINE_S} s")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)
    assert _segments() == []


def _key(r) -> tuple:
    return (r.stream_offset, int(r.record_type), r.headers.items_bytes(),
            bytes(r.content))


def _sweep(mod, source, **kw):
    it = mod.FastWARCIterator(source, parse_http=False, **kw)
    recs = [_key(r) for r in it]
    ledger = [(e.shard, e.offset, e.error_class, e.bytes_skipped, e.message)
              for e in it.error_ledger.entries()]
    return recs, ledger, it.records_skipped


def _shard(tmp_path, comp, spec=SPEC, name="s"):
    p = tmp_path / f"{name}.{comp}"
    p.write_bytes(generate_warc(spec, comp))
    return str(p)


def _entries(errors) -> list:
    return [(e.shard, e.offset, e.error_class, e.bytes_skipped, e.message)
            for e in errors]


def _same_columns(got, want) -> None:
    assert len(got) == len(want) > 0
    for name in COLUMNS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert (got.uri_heap, got.mime_heap) == (want.uri_heap, want.mime_heap)


def test_process_decoder_records_equal_thread_and_reference(tmp_path):
    # one record larger than a ring slot travels through the pipe
    big = CorpusSpec(n_pages=6, seed=9, html_words_lo=20_000,
                     html_words_hi=30_000)
    for comp in ("gzip", "lz4"):
        for spec in (SPEC, big):
            path = _shard(tmp_path, comp, spec)
            data = open(path, "rb").read()
            want = _sweep(RW, path)
            obs.reset()
            for kw in ({}, {"arena_bytes": 4096, "readahead_depth": 1}):
                assert _sweep(PW, path, **kw) == want  # child process
                assert _sweep(PW, data, **kw) == want  # child, bytes source
            snap = obs.snapshot()
            assert snap.counter("ingest.readahead.process") == 4
            assert snap.counter("ingest.readahead.thread") == 0
            assert snap.counter("decoder.members") == 4 * len(want[0])
            if spec is big:
                assert snap.counter("decoder.giant_blobs") > 0
            with open(path, "rb") as f:  # a file object: the thread
                assert _sweep(PW, f) == want
            assert _sweep(PW, path, readahead=False) == want
            assert obs.snapshot().counter("ingest.readahead.thread") == 1


def test_close_joins_child_and_unlinks_segment(tmp_path):
    path = _shard(tmp_path, "gzip", CorpusSpec(n_pages=40, seed=1))
    # a tiny watermark and a one-slot ring keep the child alive, blocked
    # on the ring, when close() lands mid-iteration
    it = PW.FastWARCIterator(path, readahead=True, readahead_depth=1,
                             arena_bytes=2048)
    gen = iter(it)
    first = next(gen)
    assert first.headers.get("WARC-Record-ID") is not None
    decoder = it._decoder
    assert type(decoder).__name__ == "ProcessReadaheadDecoder"
    assert decoder.process.is_alive() and len(_segments()) == 1
    it.close()
    assert not decoder.process.is_alive() and _segments() == []
    assert it.closed and it._decoder is None
    it.close()  # idempotent
    # a strict decode error reaches the consumer after the records
    # decoded before it, as in the reference
    data = bytearray(open(path, "rb").read())
    spans = PF.member_spans(bytes(data))
    data[spans[5][0] + 2] = 0  # member 5: unsupported compression method
    for mod in (PW, RW):
        got = []
        with pytest.raises(zlib.error, match="compression method"):
            for r in mod.FastWARCIterator(bytes(data), parse_http=False):
                got.append(_key(r))
        assert len(got) == 5


def test_decoder_stall_recovery_gives_reference_records(tmp_path,
                                                        monkeypatch):
    for comp in ("gzip", "lz4"):
        path = _shard(tmp_path, comp, name=f"stall-{comp}")
        want = _sweep(RW, path)
        monkeypatch.setenv(DECODER_STALL_S_ENV, "0.5")
        obs.reset()
        with PF.arm_decoder_stall(str(tmp_path), member=3,
                                  seconds=30.0) as latch:
            got = _sweep(PW, path, arena_bytes=2048, readahead_depth=1)
            assert os.path.exists(latch), "the stall never fired"
        assert got == want
        snap = obs.snapshot()
        assert snap.counter("decoder.respawns") == 1
        assert snap.counter(
            "faults.armed.REPRO_TORCH_FAULT_DECODER_STALL") == 1
    assert "REPRO_TORCH_FAULT_DECODER_STALL" not in os.environ


def _sweep_in_daemon(path, out):
    obs.reset()
    n = sum(1 for _ in PW.FastWARCIterator(path))
    snap = obs.snapshot()
    out.put((n, snap.counter("ingest.readahead.thread"),
             snap.counter("ingest.readahead.process")))


def test_daemonic_parent_takes_thread_decoder(tmp_path):
    path = _shard(tmp_path, "gzip")
    ctx = mp.get_context("fork")
    out = ctx.Queue()
    child = ctx.Process(target=_sweep_in_daemon, args=(path, out),
                        daemon=True)
    child.start()
    got = out.get(timeout=30)
    child.join(10)
    assert child.exitcode == 0
    assert got == (len(_sweep(RW, path)[0]), 1, 0)


def test_corrupt_warc_and_member_spans_match_reference():
    for comp in ("none", "gzip", "lz4"):
        data = generate_warc(SPEC, comp)
        assert PF.member_spans(data) == RF.member_spans(data)
        for mode in ("garble", "flip", "truncate"):
            for seed in (0, 3):
                got, spans = PF.corrupt_warc(data, fraction=0.1, seed=seed,
                                             mode=mode)
                want, rspans = RF.corrupt_warc(data, fraction=0.1, seed=seed,
                                               mode=mode)
                assert got == want
                assert [vars(s) for s in spans] == [vars(s) for s in rspans]
    with pytest.raises(ValueError):
        PF.corrupt_warc(generate_warc(SPEC, "zstd"))


@pytest.mark.parametrize("comp", ["gzip", "lz4", "none"])
def test_tolerant_ledgers_match_reference(comp, tmp_path):
    data = generate_warc(SPEC, comp)
    for mode, fraction, seed in (("garble", 0.05, 0), ("flip", 0.1, 2),
                                 ("truncate", 0.0, 0)):
        bad, spans = PF.corrupt_warc(data, fraction=fraction, seed=seed,
                                     mode=mode)
        path = tmp_path / f"bad-{mode}.{comp}"
        path.write_bytes(bad)
        for src in (str(path), bad):
            for kw in ({}, {"readahead": False},
                       {"record_types": "response"}):
                kp, kr = dict(kw), dict(kw)
                if "record_types" in kw:
                    kp["record_types"] = PW.WarcRecordType.response
                    kr["record_types"] = RW.WarcRecordType.response
                got = _sweep(PW, src, tolerant=True, **kp)
                want = _sweep(RW, src, tolerant=True, **kr)
                assert got == want, (mode, type(src), kw)
                if mode == "garble" and not kw:
                    assert len(got[1]) >= len(spans) > 0
        with open(path, "rb") as f, open(path, "rb") as g:  # the thread
            assert _sweep(PW, f, tolerant=True, readahead=True) == \
                _sweep(RW, g, tolerant=True, readahead=True)


def test_tolerant_zstd_stream_matches_reference(tmp_path):
    from repro_torch.core.warc.zstd_frames import walk_frames

    data = generate_warc(SPEC, "zstd")
    # the reserved bit of a mid-stream frame's header descriptor: the
    # decoder refuses that frame and everything after it is lost
    at = walk_frames(data)[9].comp_off + 4
    classes = []
    for bad in (data[:len(data) * 2 // 3],
                data[:at] + bytes([data[at] | 0x08]) + data[at + 1:]):
        path = tmp_path / "bad.zstd"
        path.write_bytes(bad)
        got = _sweep(PW, str(path), tolerant=True)
        assert got == _sweep(RW, str(path), tolerant=True)
        assert len(got[0]) < 61
        classes += [e[2] for e in got[1]]
    # zstd has no member to resync on: the damaged stream loses its tail
    assert "bad_zstd_stream" in classes


def test_tolerant_build_index_matches_reference(tmp_path):
    import repro.index as R

    paths = []
    for comp in ("gzip", "lz4", "none"):
        bad, _ = PF.corrupt_warc(generate_warc(SPEC, comp), fraction=0.05,
                                 seed=1)
        p = tmp_path / f"t.{comp}"
        p.write_bytes(bad)
        paths.append(str(p))
    got = build_index(paths, tolerant=True, device="cpu")
    want = R.build_index(paths, tolerant=True, fused=False)
    _same_columns(got, want)
    assert _entries(got.errors) == _entries(want.errors) and got.errors
    for readahead in (False, True):
        again = build_index(paths, tolerant=True, readahead=readahead,
                            workers=2 if readahead else 0, device="cpu")
        _same_columns(again, want)
        assert _entries(again.errors) == _entries(want.errors)
    with pytest.raises(Exception):  # strict: the damage stops the build
        build_index(paths, device="cpu")


def test_tolerant_derive_matches_reference(tmp_path):
    import repro.columnar as RC

    paths = []
    for comp in ("gzip", "lz4"):
        bad, _ = PF.corrupt_warc(generate_warc(SPEC, comp), fraction=0.05,
                                 seed=2)
        p = tmp_path / f"d.{comp}"
        p.write_bytes(bad)
        paths.append(str(p))
    store = derive(paths, str(tmp_path / "p.repcol"), tolerant=True,
                   device="cpu")
    want = RC.derive(paths, str(tmp_path / "r.repcol"), tolerant=True)
    try:
        assert (tmp_path / "p.repcol").read_bytes() == \
            (tmp_path / "r.repcol").read_bytes()
        assert _entries(store.errors) == _entries(want.errors)
        assert store.errors
        index = build_index(paths, tolerant=True, device="cpu")
        np.testing.assert_array_equal(store.digest, index.digest)
        assert _entries(index.errors) == _entries(store.errors)
    finally:
        store.close()
        want.close()
