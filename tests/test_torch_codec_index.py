"""Codec slice parity on the index path: a mixed-codec corpus (one seeded
corpus written uncompressed, as gzip members, as LZ4 frames and as zstd
frames) through ``build_index``, ``RandomAccessReader``, the query
service, ``verify_index`` and ``derive``, in both packages.

Every CDX column — the zstd frame columns ``frame_off``/``frame_base``
included — the ``.cdx`` bytes, each random-access record, the hit lists,
the verify results and the ``.repcol`` bytes are bit-identical to the
reference's. The reference and ``zstandard`` are imported by fixtures,
so the ``cuda`` test also runs where neither is installed (without
``zstandard``, over the other three codecs).
"""
import io
import signal

import numpy as np
import pytest
import torch

import repro_torch.index as P
from repro_torch.columnar import derive
from repro_torch.data.synth import CorpusSpec, generate_warc
from repro_torch.index.cdx import NO_FRAME

CODECS = ("none", "gzip", "lz4", "zstd")
SPEC = CorpusSpec(n_pages=12, seed=31, html_words_lo=30, html_words_hi=900)
COLUMNS = ("shard_id", "offset", "comp_len", "uncomp_len", "rtype", "status",
           "digest", "signatures", "frame_off", "frame_base", "uri_off",
           "mime_off")
STORE_COLUMNS = ("shard_id", "offset", "length", "rtype", "status",
                 "timestamp", "digest", "signatures", "rg_id", "rg_row",
                 "uri_off", "mime_off")
DEADLINE_S = 120


@pytest.fixture(autouse=True)
def deadline():
    def expire(signum, frame):
        raise TimeoutError(f"codec index test still running after "
                           f"{DEADLINE_S} s")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


def _have_zstandard() -> bool:
    try:
        import zstandard  # noqa: F401
    except ImportError:
        return False
    return True


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """One corpus per codec (zstd where ``zstandard`` imports)."""
    d = tmp_path_factory.mktemp("codec_index")
    paths = []
    for comp in CODECS[:4 if _have_zstandard() else 3]:
        p = d / f"s.{comp}.warc"
        p.write_bytes(generate_warc(SPEC, comp))
        paths.append(str(p))
    return paths, d


@pytest.fixture(scope="module")
def ref(shards):
    if len(shards[0]) < len(CODECS):
        pytest.skip("zstandard is not installed: no zstd shard to compare")
    import repro.columnar
    import repro.index

    return repro.index, repro.columnar


@pytest.fixture(scope="module")
def built(shards, ref):
    paths, _ = shards
    R, _ = ref
    return (P.build_index(paths, device="cpu"),
            R.build_index(paths, workers=0, fused=False))


def _same_index(got, want) -> None:
    assert len(got) == len(want) > 0
    assert (got.shard_paths, got.shard_kinds) == (want.shard_paths,
                                                 want.shard_kinds)
    for name in COLUMNS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.uri_heap, got.mime_heap) == (want.uri_heap, want.mime_heap)


def _hit_key(hits):
    return [(h.index_row, h.shard, h.offset, h.uri, h.n_matches,
             h.positions.tolist(), h.excerpt) for h in hits]


def test_build_index_every_codec_matches_reference(shards, built):
    paths, d = shards
    port, want = built
    _same_index(port, want)
    assert port.shard_kinds == list(CODECS)
    rows = np.flatnonzero(port.shard_id == 3)  # the zstd shard
    assert rows.size and all(port.frame_hint(int(i)) is not None
                             for i in rows)
    # the four shards hold the same records: every column but the
    # addressing ones agrees shard by shard
    per = [np.flatnonzero(port.shard_id == s) for s in range(4)]
    for name in ("uncomp_len", "rtype", "status", "digest", "signatures"):
        col = getattr(port, name)
        for rows in per[1:]:
            np.testing.assert_array_equal(col[rows], col[per[0]])
    port.save(str(d / "p.cdx"))
    want.save(str(d / "r.cdx"))
    assert (d / "p.cdx").read_bytes() == (d / "r.cdx").read_bytes()
    _same_index(P.CdxIndex.load(str(d / "p.cdx")), want)
    # the build published the zstd frame walk as a stage of its own
    assert port.obs.counter("index.stage.frame_walk_us") >= 0
    assert "index.stage.frame_walk_us" in port.obs.counters


def test_random_access_with_and_without_frame_hints(shards, built, ref):
    from repro_torch.core.warc import RecordReadError

    R, _ = ref
    paths, _ = shards
    port, _ = built

    def key(r):
        return (r.stream_offset, int(r.record_type), r.headers.items_bytes(),
                r.content, None if r.http_headers is None
                else r.http_headers.items_bytes())

    for sid, path in enumerate(paths):
        rows = np.flatnonzero(port.shard_id == sid)
        with P.RandomAccessReader(path) as pr, \
                R.RandomAccessReader(path) as rr:
            for i in rows[::3]:
                off, hint = int(port.offset[i]), port.frame_hint(int(i))
                got = key(pr.read(off, frame=hint))
                assert got == key(rr.read(off, frame=hint))
                assert got[3] == P.RandomAccessReader(path).read(off).content
        # the zstd reader without hints decompresses the shard once
        if CODECS[sid] == "zstd":
            with P.RandomAccessReader(path) as pr:
                for i in rows[::4]:
                    rec = pr.read(int(port.offset[i]))
                    assert rec.content_length == int(port.uncomp_len[i])
                assert pr._zbuf is not None
                with pytest.raises(RecordReadError):
                    pr.read(int(port.offset[rows[-1]]) + 10 ** 9)


def test_query_service_hits_match_reference(shards, built, ref):
    R, _ = ref
    paths, _ = shards
    port, want = built
    reqs = [(b"nginx/1.1", None, False), (rb"web arch[a-z]+", None, True),
            (b"fetch", {"status": 200}, False),
            (b"<a", {"url_prefix": b"https://research.edu/"}, False)]
    with P.IndexQueryService(port, device="cpu") as ps, \
            R.IndexQueryService(want) as rs:
        got = ps.serve([P.QueryRequest(p, P.HeaderFilter(**f) if f else None,
                                       top_k=100, regex=x)
                        for p, f, x in reqs])
        exp = rs.serve([R.QueryRequest(p, R.HeaderFilter(**f) if f else None,
                                       top_k=100, regex=x)
                        for p, f, x in reqs])
    assert [(_hit_key(g.hits), g.total_matches) for g in got] == \
        [(_hit_key(w.hits), w.total_matches) for w in exp]
    # every codec's shard answers a literal search alike
    hits = {(h.shard, h.offset): h.n_matches for h in got[0].hits}
    assert hits == P.full_scan_search(paths, b"nginx/1.1") and hits
    counts = [sorted(n for (s, _), n in hits.items() if s == p)
              for p in paths]
    assert counts[1:] == counts[:1] * 3


def test_verify_index_flags_exactly_the_flipped_rows(built, ref):
    R, _ = ref
    port, want = built
    assert P.verify_index(port, device="cpu") == [True] * len(port)
    assert all(P.verify_index(port, check_signatures=True, device="cpu"))
    flips = [int(np.flatnonzero(port.shard_id == s)[5]) for s in (2, 3)]
    for idx in (port, want):
        idx.digest[flips] ^= np.uint32(1)
    try:
        got = P.verify_index(port, device="cpu")
        assert got == R.verify_index(want, use_kernel=False)
        assert [i for i, ok in enumerate(got) if not ok] == flips
    finally:
        for idx in (port, want):
            idx.digest[flips] ^= np.uint32(1)


def test_derive_store_matches_reference(shards, built, ref, tmp_path):
    _, RC = ref
    paths, _ = shards
    port_index, _ = built
    sub = paths[2:]  # the LZ4 and the zstd shard
    store = derive(sub, str(tmp_path / "p.repcol"), device="cpu")
    want = RC.derive(sub, str(tmp_path / "r.repcol"))
    try:
        assert (tmp_path / "p.repcol").read_bytes() == \
            (tmp_path / "r.repcol").read_bytes()
        for name in STORE_COLUMNS:
            np.testing.assert_array_equal(getattr(store, name),
                                          getattr(want, name), name)
        rows = np.flatnonzero(port_index.shard_id >= 2)
        for name, col in (("offset", "offset"), ("length", "uncomp_len"),
                          ("digest", "digest"),
                          ("signatures", "signatures")):
            np.testing.assert_array_equal(getattr(store, name),
                                          getattr(port_index, col)[rows])
        for i in range(len(store)):
            assert store.payload(i) == want.payload(i)
        # the store's own index flags zstd rows as frameless
        synth = store.as_index()
        zrows = synth.shard_id == 1
        assert zrows.any() and np.all(synth.frame_off[zrows] == NO_FRAME)
        del synth
    finally:
        store.close()  # no view of the store is left: closes cleanly
        del want


@pytest.mark.cuda
def test_cuda_mixed_codec_build_equals_cpu(shards):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch import obs

    paths, _ = shards
    obs.reset()
    got = P.build_index(paths, device="cuda")
    assert got.obs.counter("kernel.digest_sig.launches") > 0
    _same_index(got, P.build_index(paths, device="cpu"))
    assert P.verify_index(got, device="cuda") == [True] * len(got)
