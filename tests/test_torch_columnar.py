"""Columnar slice parity: corpus → ``derive`` → ``.repcol`` → column scans.

The port (``repro_torch``, on the CPU) and the JAX reference (``repro``,
Pallas in interpret mode) run on the same seeded inputs: container and
store bytes, row-group plans, the row-group kernel wrappers, and the hit
lists of the columnar query path must be identical, and equal to the
port's own CDX+seek path. Cases are loops inside few tests (the file
keeps a small item count). The reference is imported by the ``ref``
fixture, not at module level, so the ``cuda`` test also runs where JAX is
absent: ``pytest -m cuda tests/test_torch_columnar.py``.
"""
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch.columnar as PC
import repro_torch.index as P
from repro_torch.core.warc import FastWARCIterator
from repro_torch.data.synth import CorpusSpec, write_corpus
from repro_torch.kernels.digest_sig import digest_signature_rowgroup
from repro_torch.kernels.pattern_scan import find_pattern_mask_rowgroup

PAD = 128  # ROWGROUP_PAD of both packages
STORE_COLUMNS = ("shard_id", "offset", "length", "rtype", "status",
                 "timestamp", "digest", "signatures", "rg_id", "rg_row",
                 "uri_off", "mime_off", "rg_width", "rg_rows", "rg_padded",
                 "rg_byte_off", "rg_order")
# (pattern, regex?, filter kwargs): literals (broad, longer than the
# kernel window, below the n-gram, a miss), regexes with and without a
# literal, header filters
QUERIES = [(b"Server:", False, None),
           (b"Content-Type: text/html", False, None),
           (b"<a", False, {"url_prefix": b"https://"}),
           (b"zz-never-there", False, None),
           (b"html", False, {"status": 200}),
           (rb"Serv[a-z]+:", True, None),
           (rb"[0-9]{4}", True, None),
           (rb"nginx/1\.2[0-9]\r\n", True, {"status": 200})]


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's columnar package, index and row-group wrappers."""
    import repro.columnar
    import repro.index
    from repro.kernels.digest_sig import digest_signature_rowgroup
    from repro.kernels.pattern_scan import find_pattern_mask_rowgroup

    return SimpleNamespace(columnar=repro.columnar, index=repro.index,
                           digest_rg=digest_signature_rowgroup,
                           find_rg=find_pattern_mask_rowgroup)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, ref):
    """One gzip and one uncompressed shard, derived by both packages and
    indexed by the port."""
    d = tmp_path_factory.mktemp("torch_columnar")
    paths = []
    for i, comp in enumerate(["gzip", "none"]):
        p = str(d / f"s{i}.warc{'.gz' if comp == 'gzip' else ''}")
        write_corpus(p, CorpusSpec(n_pages=10, seed=70 + i), comp)
        paths.append(p)
    port = PC.derive(paths, str(d / "port.repcol"), device="cpu")
    ref_store = ref.columnar.derive(paths, str(d / "ref.repcol"))
    return paths, port, ref_store, P.build_index(paths, device="cpu"), d


def _hit_key(hits):
    return [(h.index_row, h.shard, h.offset, h.uri, h.n_matches,
             h.positions.tolist(), h.excerpt) for h in hits]


def _search(engine, pattern, regex, flt, cls):
    flt = None if flt is None else cls(**flt)
    return (engine.search_regex(pattern, flt) if regex
            else engine.search(pattern, flt))


def test_codec_bytes_equal_and_cross_open(tmp_path, ref):
    RC = ref.columnar
    rng = np.random.default_rng(3)
    arrays = {"u8": rng.integers(0, 256, 7, dtype=np.uint8),
              "i16": rng.integers(-5, 5, (3, 4), dtype=np.int16),
              "u64": rng.integers(0, 1 << 62, 5, dtype=np.uint64),
              "scalar": np.asarray(1.5)}
    chunks = [rng.integers(0, 256, n, dtype=np.uint8) for n in (1, 64, 100)]
    files = {}
    for name, mod in (("port", PC), ("ref", RC)):
        path = str(tmp_path / f"{name}.col")
        with mod.ColumnWriter(path, meta={"k": [1, "a"], "n": 3}) as w:
            w.begin_blob("blob")
            assert [w.append(c) for c in chunks] == [0, 1, 65]
            w.end_blob()
            for key, arr in arrays.items():
                w.add_array(key, arr)
            w.add_blob("small", b"xyz")
        files[name] = path
    assert (open(files["port"], "rb").read()
            == open(files["ref"], "rb").read())
    for reader in (PC.ColumnFile, RC.ColumnFile):
        for path in files.values():
            f = reader(path)
            assert f.meta == {"k": [1, "a"], "n": 3}
            for key, arr in arrays.items():
                got = f.array(key)
                assert got.dtype == arr.dtype
                np.testing.assert_array_equal(got, arr)
            np.testing.assert_array_equal(f.view("blob", 1, (64,)),
                                          chunks[1])
            assert f.blob("small") == b"xyz"
            del got
            f.close()


def test_pack_plan_equal(ref):
    RC = ref.columnar
    rng = np.random.default_rng(11)
    for case in range(6):
        lengths = rng.integers(0, 40_000, 300 + 50 * case)
        lengths[:5] = [0, 1, 2048, 2049, 255]
        caps = ({} if case % 2 else
                {"max_rows": 7 + case, "max_bytes": 60_000 * (case + 1)})
        port = PC.pack_plan(lengths, **caps)
        want = RC.pack_plan(lengths, **caps)
        assert len(port) == len(want) > 0
        for a, b in zip(port, want):
            assert (a.width, a.padded_rows, a.nbytes) == (b.width,
                                                          b.padded_rows,
                                                          b.nbytes)
            np.testing.assert_array_equal(a.rows, b.rows)


def test_derive_repcol_bytes_equal(corpus, ref):
    RC = ref.columnar
    paths, port, _, index, d = corpus
    assert ((d / "port.repcol").read_bytes()
            == (d / "ref.repcol").read_bytes())
    assert port.n_rowgroups > 1 and len(set(port.shard_kinds)) == 2
    for raw in (b"2021-03-04T05:06:07Z", b" 2021-03-04T05:06:07Z\r\n",
                b"2021-03-04", b"\xff", b"", None):
        assert PC.parse_warc_date(raw) == RC.parse_warc_date(raw)
    # each package's reader opens the other's file
    for mod, path in ((PC, "ref.repcol"), (RC, "port.repcol")):
        other = mod.ColumnStore(str(d / path))
        for name in STORE_COLUMNS:
            np.testing.assert_array_equal(getattr(other, name),
                                          getattr(port, name), name)
        assert (other.uri_heap, other.mime_heap) == (port.uri_heap,
                                                    port.mime_heap)
        other.close()
    # what the serial port does not cover raises instead of degrading
    for kw in ({"workers": 2}, {"tolerant": True}, {"supervise": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PC.derive(paths, str(d / "x.repcol"), device="cpu", **kw)
    with pytest.raises(ValueError):  # a geometry the kernel does not cover
        PC.derive(paths, str(d / "x.repcol"), sig_bits=192, device="cpu")


def test_store_columns_equal_cdx_build(corpus):
    paths, port, _, index, d = corpus
    pairs = {"shard_id": "shard_id", "offset": "offset",
             "length": "uncomp_len", "rtype": "rtype", "status": "status",
             "digest": "digest", "signatures": "signatures",
             "uri_off": "uri_off", "mime_off": "mime_off"}
    for col, idx_col in pairs.items():
        a, b = getattr(port, col), getattr(index, idx_col)
        assert a.dtype == b.dtype, col
        np.testing.assert_array_equal(a, b, col)
    assert (port.uri_heap, port.mime_heap) == (index.uri_heap,
                                               index.mime_heap)
    assert port.shard_paths == index.shard_paths
    as_idx = port.as_index()
    np.testing.assert_array_equal(as_idx.signatures, index.signatures)
    row = 0
    for path in paths:
        for rec in FastWARCIterator(path, parse_http=False):
            assert port.payload(row) == rec.content
            row += 1
    assert row == len(port) == len(index)
    assert 0 < port.pad_waste_ratio() < 1


def _rowgroup_matrix(rng, rows: int, width: int, live: int,
                     pattern: bytes) -> tuple[np.ndarray, np.ndarray]:
    """A (rows, width + PAD) row-group with ``live`` payload rows over a
    small alphabet. Every row starts with the pattern and ends, by row,
    with its 16-, 4- or 1-byte prefix (each at the last valid position
    for that length) or its 9-byte prefix (straddling the row's end for
    longer patterns); the fifth live row is all 0xFF."""
    alphabet = np.frombuffer(b"WARC/1.\r\n-T", np.uint8)
    m = np.zeros((rows, width + PAD), np.uint8)
    lengths = rng.integers(16, width + 1, live)
    lengths[0] = width
    pat = np.frombuffer(pattern, np.uint8)
    for r, n in enumerate(lengths):
        m[r, :n] = rng.choice(alphabet, n)
        m[r, :16] = pat
        k = (16, 4, 1, 9)[r % 4]
        m[r, n - k:n] = pat[:k]
    if live > 4:
        m[4, :lengths[4]] = 0xFF
    return m, lengths.astype(np.int64)


def test_find_pattern_mask_rowgroup_matches_reference(ref):
    pattern = b"WARC/1.1\r\nWARC-T"
    rng = np.random.default_rng(5)
    for width in (256, 4096):
        m, lengths = _rowgroup_matrix(rng, 7, width, 5, pattern)
        for plen in (1, 4, 16):
            for trim in (True, False):
                got = find_pattern_mask_rowgroup(m, lengths, pattern[:plen],
                                                 trim=trim, device="cpu")
                want = np.asarray(ref.find_rg(m, lengths, pattern[:plen],
                                              trim=trim))
                assert got.shape == want.shape == (5, width)
                np.testing.assert_array_equal(got, want)
                assert got.any()
    for bad in (np.zeros((2, 100), np.uint8),       # no zero tail
                np.zeros((2, 256 + PAD), np.int32)):  # not bytes
        with pytest.raises(ValueError):
            find_pattern_mask_rowgroup(bad, [1], b"a", device="cpu")
    with pytest.raises(ValueError):  # more live rows than the matrix holds
        find_pattern_mask_rowgroup(m, np.ones(8, np.int64), b"a",
                                   device="cpu")
    with pytest.raises(ValueError):  # all-zero pattern
        find_pattern_mask_rowgroup(m, lengths, b"\0\0", device="cpu")


def test_digest_signature_rowgroup_matches_reference(ref):
    rng = np.random.default_rng(9)
    for width in (256, 1536):
        m = np.zeros((6, width + PAD), np.uint8)
        lengths = np.asarray([width, 0, 3, width - 1, 17], np.int64)
        for r, n in enumerate(lengths):
            m[r, :n] = rng.integers(0, 256, n, dtype=np.uint8)
        m[3, :width - 1] = 0xFF  # forces the uint32 hash wrap
        got = digest_signature_rowgroup(m, lengths, block=width, device="cpu")
        want = ref.digest_rg(m, lengths, block=width)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    with pytest.raises(ValueError):  # width not a multiple of the block
        digest_signature_rowgroup(m, lengths, block=1024, device="cpu")


def test_execute_columnar_matches_reference_and_cdx(corpus, ref,
                                                   monkeypatch):
    import repro_torch.kernels.pattern_scan as scan_pkg

    R = ref.index
    paths, port, ref_store, index, d = corpus
    col = P.QueryEngine(index, store=port, device="cpu")
    cdx = P.QueryEngine(index, device="cpu")
    ref_col = R.QueryEngine.from_store(ref_store)
    branches = set()

    def observed(matrix, *args, **kwargs):
        # dense groups pass the store's read-only mapping, sparse groups a
        # gathered copy
        branches.add("sparse" if matrix.flags.writeable else "dense")
        return find_pattern_mask_rowgroup(matrix, *args, **kwargs)

    monkeypatch.setattr(scan_pkg, "find_pattern_mask_rowgroup", observed)
    # one page's records: single candidates in large groups (sparse)
    narrow = (b"e", False, {"url_prefix": index.uri(1)})
    for pattern, regex, flt in QUERIES + [narrow]:
        got = _search(col, pattern, regex, flt, P.HeaderFilter)
        want = _search(ref_col, pattern, regex, flt, R.HeaderFilter)
        assert _hit_key(got) == _hit_key(want), pattern
        pflt = None if flt is None else P.HeaderFilter(**flt)
        plan = (col.plan_regex(pattern, pflt) if regex
                else col.plan(pattern, pflt))
        assert _hit_key(cdx.execute(plan)) == _hit_key(got), pattern
    assert branches == {"dense", "sparse"}
    # every response ends in "</html>": a match at each row's last valid
    # position, and patterns straddling the row's end into the zero tail
    # (a trailing zero byte matches the tail: only the end filter drops
    # it); no pre-filter, so the kernel scans every record
    for pattern, n_hits in ((b"</html>", 20), (b"</html>\r\n", 0),
                            (b"</html>\0", 0)):
        plan = col.plan(pattern, prefilter=False)
        got = col.execute(plan)
        want = ref_col.execute(ref_col.plan(pattern, prefilter=False))
        assert _hit_key(got) == _hit_key(want) == _hit_key(cdx.execute(plan))
        assert len(got) == n_hits
    assert col.stats["store_fetches"] == 0
    assert cdx.stats["store_fetches"] == 0


def test_from_store_service_matches_full_scan(corpus):
    paths, port, _, index, d = corpus
    engine = P.QueryEngine.from_store(port, device="cpu")
    svc = P.IndexQueryService(engine.index, engine=engine)
    assert svc.engine is engine
    reqs = [P.QueryRequest(b"Server:", top_k=1000),
            P.QueryRequest(rb"Serv[a-z]+:", top_k=1000, regex=True)]
    oracles = [P.full_scan_search(paths, b"Server:"),
               P.full_scan_regex(paths, rb"Serv[a-z]+:")]
    for resp, oracle in zip(svc.serve(reqs), oracles):
        got = {(h.shard, h.offset): h.n_matches for h in resp.hits}
        assert got == oracle and resp.total_matches == len(oracle) > 0
    assert engine.stats["kernel_dispatches"] > 0
    assert engine.stats["store_fetches"] == 0  # short literal: no copy-out
    # the batch path of a store-backed engine fetches from the store
    plan = engine.plan(b"Server:")
    hits = engine.execute(plan, columnar=False)
    assert engine.stats["store_fetches"] == plan.rows.size > 0
    assert _hit_key(hits) == _hit_key(engine.execute(plan))


def test_time_range_parity(corpus, ref):
    R = ref.index
    paths, port, ref_store, index, d = corpus
    col = P.QueryEngine(index, store=port, device="cpu")
    ref_col = R.QueryEngine.from_store(ref_store)
    ts = np.asarray(port.timestamp, np.int64)
    lo, hi = int(ts.min()), int(ts.max()) + 1
    mid = int(np.median(ts))
    for rng in ((lo, hi), (lo, mid), (mid, hi), (0, 1)):
        got = col.search(b"Server:", P.HeaderFilter(time_range=rng))
        want = ref_col.search(b"Server:", R.HeaderFilter(time_range=rng))
        assert _hit_key(got) == _hit_key(want), rng
        np.testing.assert_array_equal(
            col.header_mask(P.HeaderFilter(time_range=rng)),
            (ts >= rng[0]) & (ts < rng[1]))
    assert _hit_key(col.search(b"Server:", P.HeaderFilter(
        time_range=(lo, hi)))) == _hit_key(col.search(b"Server:"))
    with pytest.raises(ValueError, match="attach_store"):
        P.QueryEngine(index, device="cpu").search(
            b"x", P.HeaderFilter(time_range=(0, 1)))


def test_attach_store_refuses_foreign_corpus(corpus, ref, tmp_path):
    paths, port, _, index, d = corpus
    other = str(tmp_path / "other.warc")
    write_corpus(other, CorpusSpec(n_pages=3, seed=99), "none")
    moved = [str(tmp_path / f"moved{i}") for i in range(len(paths))]
    for src, dst in zip(paths, moved):
        shutil.copy(src, dst)
    for shards in ([other], moved):
        foreign = PC.derive(shards, str(tmp_path / "f.repcol"), device="cpu")
        with pytest.raises(ValueError) as port_err:
            P.QueryEngine(index, store=foreign, device="cpu")
        # the reference engine checks the same columns of the same objects
        with pytest.raises(ValueError) as ref_err:
            ref.index.QueryEngine(index).attach_store(foreign)
        assert str(port_err.value) == str(ref_err.value)
        foreign.close()


def test_store_close_borrow_rule(tmp_path):
    path = str(tmp_path / "one.warc")
    write_corpus(path, CorpusSpec(n_pages=2, seed=3), "none")
    store = PC.derive([path], str(tmp_path / "one.repcol"), device="cpu")
    engine = P.QueryEngine.from_store(store, device="cpu")
    assert engine.search(b"WARC")
    del engine  # its index columns are views of the mapping
    matrix, rows, lens = store.rowgroup(0)
    mask = find_pattern_mask_rowgroup(matrix, lens, b"WARC", trim=False,
                                      device="cpu")
    assert mask.shape == (lens.size, matrix.shape[1] - PAD)
    with pytest.raises(BufferError):
        store.close()
    del matrix, rows
    store.close()  # the scan and the search left no borrow behind


def test_entry_points_default_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    path = str(tmp_path / "a.warc.gz")
    write_corpus(path, CorpusSpec(n_pages=1), "gzip")
    store = PC.derive([path], str(tmp_path / "a.repcol"), device="cpu")
    m = np.zeros((1, 256 + PAD), np.uint8)
    for call in (lambda: PC.derive([path], str(tmp_path / "b.repcol")),
                 lambda: P.QueryEngine.from_store(store),
                 lambda: find_pattern_mask_rowgroup(m, [3], b"a"),
                 lambda: digest_signature_rowgroup(m, [3], block=256)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    store.close()


@pytest.mark.cuda
def test_cuda_pattern_scan_rowgroup_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels.pattern_scan import pattern_scan as mod

    pattern = b"WARC/1.1\r\nWARC-T"
    vec = np.frombuffer(pattern, np.uint8).copy()
    rng = np.random.default_rng(1)
    for width in (256, 1536, 2048, 8192):
        m, lengths = _rowgroup_matrix(rng, 7, width, 5, pattern)
        x = torch.from_numpy(m).cuda()
        for plen in (1, 4, 16):
            before = mod.rowgroup_launches
            got = mod.pattern_scan_rowgroup(x, vec, plen)
            torch.cuda.synchronize()
            assert mod.rowgroup_launches == before + 1
            assert torch.equal(got, mod.pattern_scan_rowgroup_plain(
                x, vec, plen))
            for trim in (True, False):
                np.testing.assert_array_equal(
                    find_pattern_mask_rowgroup(m, lengths, pattern[:plen],
                                               trim=trim, device="cuda"),
                    find_pattern_mask_rowgroup(m, lengths, pattern[:plen],
                                               trim=trim, device="cpu"))
        if width < 2048:
            for g, w in zip(
                    digest_signature_rowgroup(m, lengths, block=width,
                                              device="cuda"),
                    digest_signature_rowgroup(m, lengths, block=width,
                                              device="cpu")):
                np.testing.assert_array_equal(g, w)
