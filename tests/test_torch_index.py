"""Index slice parity: corpus → ``build_index`` → queries, both packages.

The port (``repro_torch``, on the CPU) and the JAX reference (``repro``,
Pallas in interpret mode) run on the same seeded corpora: the synthetic
generator's bytes, the CDX columns and ``.cdx`` file bytes, cross-loading
of each other's indexes, and the hit lists of literal, regex,
short-literal and header-filtered searches must all be identical.
"""
import os

import numpy as np
import pytest

import repro.index as R
from repro.data.synth import generate_warc as ref_generate_warc

import repro_torch.index as P
from repro_torch.core.warc import RecordReadError
from repro_torch.data.synth import CorpusSpec, generate_warc

SPECS = [CorpusSpec(n_pages=12, seed=5, html_words_lo=30, html_words_hi=900),
         CorpusSpec(n_pages=12, seed=6, html_words_lo=30, html_words_hi=900)]
COLUMNS = ("shard_id", "offset", "comp_len", "uncomp_len", "rtype", "status",
           "digest", "signatures", "frame_off", "frame_base", "uri_off",
           "mime_off")
# (pattern, header filter) per query kind: literals (a short one below
# the n-gram, one longer than the kernel window) and regexes, with and
# without header filters
QUERIES = {
    "literal": [(b"nginx/1.1", None), (b"university science", None),
                (b"<!doctype html><html><head><title>", None),
                (b"<a", {"url_prefix": b"https://research.edu/"}),
                (b"web archive", {"status": 200})],
    "regex": [(rb"nginx/1\.2[0-9]\r\nDate", None), (rb"(?i)WEB archive", None),
              (rb"fetchTimeMs: [0-9]+", {"status": 200})],
}


@pytest.fixture(scope="module", params=["gzip", "none"])
def corpus(request, tmp_path_factory):
    """Two shards of one compression, indexed by both packages."""
    comp = request.param
    d = tmp_path_factory.mktemp(f"torch_index_{comp}")
    paths = []
    for spec in SPECS:
        p = d / f"s{spec.seed}.warc{'.gz' if comp == 'gzip' else ''}"
        p.write_bytes(generate_warc(spec, comp))
        paths.append(str(p))
    return (paths, P.build_index(paths, device="cpu"),
            R.build_index(paths, fused=True), d)


def _hit_key(hits):
    return [(h.index_row, h.shard, h.offset, h.uri, h.n_matches,
             h.positions.tolist(), h.excerpt) for h in hits]


def test_generate_warc_byte_identical():
    spec = CorpusSpec(n_pages=3, seed=9)
    for comp in ("gzip", "none"):
        assert generate_warc(spec, comp) == ref_generate_warc(spec, comp)


def test_build_index_columns_and_cdx_bytes_equal(corpus):
    paths, port, ref, d = corpus
    assert len(port) == len(ref) > 0
    assert (port.shard_paths, port.shard_kinds) == (ref.shard_paths,
                                                   ref.shard_kinds)
    for name in COLUMNS:
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (port.uri_heap, port.mime_heap) == (ref.uri_heap, ref.mime_heap)
    port.save(str(d / "port.cdx"))
    ref.save(str(d / "ref.cdx"))
    assert (d / "port.cdx").read_bytes() == (d / "ref.cdx").read_bytes()


def test_indexes_cross_load(corpus):
    paths, port, ref, d = corpus
    ref.save(str(d / "ref_x.cdx"))
    loaded = P.CdxIndex.load(str(d / "ref_x.cdx"))
    cols = {name: getattr(ref, name) for name in COLUMNS}
    made = P.CdxIndex.from_columns(
        cols, ref.uri_heap, ref.mime_heap, shard_paths=ref.shard_paths,
        shard_kinds=ref.shard_kinds, sig_bits=ref.sig_bits,
        sig_ngram=ref.sig_ngram, sig_hashes=ref.sig_hashes)
    for idx in (loaded, made):
        for name in COLUMNS:
            np.testing.assert_array_equal(getattr(idx, name),
                                          getattr(port, name))
        assert idx.entry(3) == port.entry(3)
    port.save(str(d / "port_x.cdx"))
    back = R.CdxIndex.load(str(d / "port_x.cdx"))
    np.testing.assert_array_equal(back.signatures, port.signatures)
    bad = dict(cols, digest=cols["digest"].astype(np.int64))
    with pytest.raises(ValueError):
        P.CdxIndex.from_columns(
            bad, ref.uri_heap, ref.mime_heap, shard_paths=ref.shard_paths,
            shard_kinds=ref.shard_kinds, sig_bits=ref.sig_bits,
            sig_ngram=ref.sig_ngram, sig_hashes=ref.sig_hashes)


@pytest.mark.parametrize("kind", ["literal", "regex"])
def test_search_parity(corpus, kind):
    paths, port, ref, _ = corpus
    # the reference reads the index it built; the port its own
    with P.QueryEngine(port, device="cpu") as pe, R.QueryEngine(ref) as re_:
        for pattern, flt in QUERIES[kind]:
            pf = P.HeaderFilter(**flt) if flt else None
            rf = R.HeaderFilter(**flt) if flt else None
            if kind == "regex":
                got, want = pe.search_regex(pattern, pf), re_.search_regex(
                    pattern, rf)
            else:
                got, want = pe.search(pattern, pf), re_.search(pattern, rf)
            assert _hit_key(got) == _hit_key(want), pattern
            if flt is None:
                oracle = (P.full_scan_regex if kind == "regex"
                          else P.full_scan_search)(paths, pattern)
                assert {(h.shard, h.offset): h.n_matches
                        for h in got} == oracle, pattern
                assert oracle == (R.full_scan_regex if kind == "regex"
                                  else R.full_scan_search)(paths, pattern)
        assert pe.stats == {k: re_.stats[k] for k in pe.stats}


def test_service_parity(corpus):
    paths, port, ref, _ = corpus
    reqs = [(b"nginx/1.1", None, False), (rb"web arch[a-z]+", None, True),
            (b"fetch", {"status": 200}, False)]
    with P.IndexQueryService(port, device="cpu") as ps, \
            R.IndexQueryService(ref) as rs:
        got = ps.serve([P.QueryRequest(p, P.HeaderFilter(**f) if f else None,
                                       top_k=3, regex=x)
                        for p, f, x in reqs])
        want = rs.serve([R.QueryRequest(p, R.HeaderFilter(**f) if f else None,
                                        top_k=3, regex=x)
                         for p, f, x in reqs])
    assert [(_hit_key(g.hits), g.total_matches) for g in got] == \
        [(_hit_key(w.hits), w.total_matches) for w in want]
    assert ps.stats["requests"] == 3 and ps.stats["hits_returned"] == \
        rs.stats["hits_returned"]


def test_random_access_and_not_ported_paths(corpus):
    paths, port, _, _ = corpus
    with P.RandomAccessReader(paths[0]) as reader:
        rec = reader.read(port.entry(1).offset)
        assert rec.stream_offset == int(port.offset[1])
        assert rec.content_length == int(port.uncomp_len[1])
        with pytest.raises(RecordReadError):  # past the last record
            reader.read(os.path.getsize(paths[0]))
    with P.QueryEngine(port, device="cpu") as engine:
        # both need a columnar store, which this engine does not have
        with pytest.raises(ValueError, match="attach_store"):
            engine.search(b"web", P.HeaderFilter(time_range=(0, 1)))
        with pytest.raises(ValueError, match="no columnar store"):
            engine.execute(engine.plan(b"web"), columnar=True)
    with pytest.raises(ValueError):
        P.build_index(paths, sig_bits=192, device="cpu")
