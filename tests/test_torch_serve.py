"""Gateway slice parity: multi-pattern scans, record cache, ``ArchiveGateway``.

The port (``repro_torch``, on the CPU, where each kernel wrapper runs its
plain PyTorch version) and the JAX reference (``repro``, Pallas in
interpret mode) get the same seeded inputs: the per-row-pattern mask
wrappers, the cache's admission and eviction decisions, the metrics
registry and every gateway response must be identical, and gateway
responses must equal the port's own synchronous ``QueryEngine``. Cases
are loops inside few tests (the file keeps a small item count). The
reference is imported by the ``ref`` fixture, not at module level, so
the ``cuda`` tests also run where JAX is absent:
``pytest -m cuda tests/test_torch_serve.py``.
"""
import os
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch.index as P
from repro_torch import obs
from repro_torch.core.warc.record import WarcRecordType
from repro_torch.data.synth import CorpusSpec, write_corpus
from repro_torch.kernels.pattern_scan import (
    find_pattern_mask_batch, find_pattern_mask_rowgroup,
    find_pattern_masks_multi, find_pattern_masks_multi_rowgroup)
from repro_torch.obs import export, flight, trace
from repro_torch.obs.kernels import reset_shape_cache
from repro_torch.obs.registry import HISTOGRAM_CAP, Registry
from repro_torch.serve import ArchiveGateway, RecordCache, ShardedRecordCache
from repro_torch.serve import archive
from repro_torch.serve.cache import FrequencySketch
from repro_torch.serve.shard import _DISPATCH_LOCK

SCAN_BLOCK = 256  # small tiles keep the interpreted reference grid short
PAD = 128         # ROWGROUP_PAD of both packages
PATTERNS = [b"W", b"WA", b"ARC/", b"WARC/1.1", b"C/1.1\r\nW",
            b"WARC/1.1\r\nWARC-T", b"T", b"1.1\r"]
# literal, regex, filtered, miss and duplicate requests
REQUESTS = [(b"nginx", False, None, 5), (b"archive", False, None, 3),
            (b"absent-from-corpus", False, None, 10),
            (rb"nginx/1\.1[0-9]", True, None, 10),
            (b"crawl", False, {"record_type": WarcRecordType.response}, 10),
            (b"</html>", False, None, 2), (rb"[Cc]rawl", True, None, 10),
            (b"q", False, None, 10), (b"nginx", False, None, 5),
            (b"Server:", False, {"status": 200}, 4)]


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's serve, index and pattern-scan wrappers, its
    metrics registry and its shard-kill fault helper."""
    import repro.index
    import repro.obs
    import repro.serve
    from repro.kernels.pattern_scan import (
        find_pattern_masks_multi, find_pattern_masks_multi_rowgroup)
    from repro.obs import export as ref_export
    from repro.obs.kernels import reset_shape_cache as ref_reset_shapes
    from repro.obs.registry import Registry as RefRegistry
    from repro.serve.cache import FrequencySketch as RefSketch
    from repro.testing import arm_scheduler_shard_kill

    return SimpleNamespace(
        index=repro.index, obs=repro.obs, serve=repro.serve,
        multi=find_pattern_masks_multi,
        multi_rg=find_pattern_masks_multi_rowgroup,
        export=ref_export, reset_shapes=ref_reset_shapes,
        Registry=RefRegistry, Sketch=RefSketch,
        arm_shard_kill=arm_scheduler_shard_kill)


def _scan_rows(seed: int, sizes) -> list[bytes]:
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"WARC/1.\r\n-T", np.uint8)
    pat = PATTERNS[5]
    out = []
    for i, size in enumerate(sizes):
        buf = bytearray(rng.choice(alphabet, size).tobytes())
        k = (16, 9, 4, 1)[i % 4]  # a pattern prefix ending at the row's end
        if size >= k:
            buf[size - k:] = pat[:k]
        out.append(bytes(buf))
    return out


def test_multi_wrappers_match_reference(ref):
    # 5 + 2 + 1 rows over three width buckets: the 5-row bucket is padded
    # to 6 with an inert row; pattern lengths 1..16 share each launch
    bufs = _scan_rows(0, (0, 5, 100, 200, 255, 256, 500, 700))
    pats = [PATTERNS[i % len(PATTERNS)] for i in range(len(bufs))]
    obs.reset()
    reset_shape_cache()
    ref.obs.reset()
    ref.reset_shapes()
    got = find_pattern_masks_multi(bufs, pats, block=SCAN_BLOCK,
                                   device="cpu")
    want = ref.multi(bufs, pats, block=SCAN_BLOCK, interpret=True)
    for g, w, b in zip(got, want, bufs):
        assert g.dtype == np.uint8 and g.shape == (len(b),)
        np.testing.assert_array_equal(g, w)
    assert sum(int(g.sum()) for g in got) > len(bufs)

    def mine(counters):
        return {k: v for k, v in counters.items()
                if k.startswith("kernel.find_pattern_masks_multi.")}

    counters = mine(obs.snapshot().counters)
    assert counters == mine(ref.obs.snapshot().counters)
    assert counters["kernel.find_pattern_masks_multi.w256.padded_bytes"] \
        == 6 * 256  # 5 rows + 1 inert pad row
    # one pattern for all rows: the multi form equals the single form
    same = find_pattern_masks_multi(bufs, [PATTERNS[3]] * len(bufs),
                                    block=SCAN_BLOCK, device="cpu")
    for g, w in zip(same, find_pattern_mask_batch(
            bufs, PATTERNS[3], block=SCAN_BLOCK, device="cpu")):
        np.testing.assert_array_equal(g, w)
    # row-group form: live rows < matrix rows, one pattern per live row
    rng = np.random.default_rng(1)
    for width, live in ((256, 6), (512, 3)):
        m = np.zeros((live + 2, width + PAD), np.uint8)
        lengths = rng.integers(0, width + 1, live)
        lengths[0] = width
        for r, row in enumerate(_scan_rows(width, lengths)):
            m[r, :len(row)] = np.frombuffer(row, np.uint8)
        rpats = [PATTERNS[(i * 3) % len(PATTERNS)] for i in range(live)]
        got = find_pattern_masks_multi_rowgroup(m, lengths, rpats,
                                                device="cpu")
        want = ref.multi_rg(m, lengths, rpats, interpret=True)
        assert got.shape == (live, width)
        np.testing.assert_array_equal(got, want)
        for i, p in enumerate(rpats):  # == the single-pattern row-group scan
            np.testing.assert_array_equal(
                got[i], find_pattern_mask_rowgroup(m, lengths, p,
                                                   device="cpu")[i])
    for call in (lambda f: f([b"ab"], [b"a", b"b"]),
                 lambda f: f([b"ab"], [b""]),
                 lambda f: f([b"ab"], [b"\0\0"])):
        with pytest.raises(ValueError):
            call(lambda b, p: find_pattern_masks_multi(b, p, device="cpu"))
        with pytest.raises(ValueError):
            call(ref.multi)
    with pytest.raises(ValueError):
        find_pattern_masks_multi_rowgroup(m, lengths, rpats[:-1],
                                          device="cpu")


def _trace(seed: int, n: int) -> list[tuple]:
    """Seeded get/put trace over zipf-ish keys with ragged sizes."""
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.3, n) % 97).tolist()
    sizes = rng.integers(1, 900, 97).tolist()
    return [("get" if rng.random() < 0.6 else "put", (k % 3, 1000 * k),
             sizes[k]) for k in keys]


def test_cache_decisions_equal_to_reference(ref):
    ops = _trace(3, 4000)

    def drive(cache):
        out = []
        for op, key, size in ops:
            if op == "get":
                out.append(cache.get(key) is not None)
            else:
                out.append(cache.put(key, bytes(size)))
        return out, cache.snapshot()

    for policy in ("lru", "tinylfu"):
        mine = drive(RecordCache(8 << 10, admission=policy))
        theirs = drive(ref.serve.RecordCache(8 << 10, admission=policy))
        assert mine == theirs
        assert mine[1]["hits"] and mine[1]["evictions"]
    mine_sh = ShardedRecordCache(12 << 10, 3)
    theirs_sh = ref.serve.ShardedRecordCache(12 << 10, 3)
    keys = sorted({key for _, key, _ in ops})
    assert [mine_sh.slice_for(k) for k in keys] == \
        [theirs_sh.slice_for(k) for k in keys]
    assert drive(mine_sh) == drive(theirs_sh)
    mine_sh.remove_slice(1)
    theirs_sh.remove_slice(1)
    assert [mine_sh.slice_for(k) for k in keys] == \
        [theirs_sh.slice_for(k) for k in keys]
    assert 1 not in {mine_sh.slice_for(k) for k in keys}
    assert drive(mine_sh) == drive(theirs_sh)
    sk, rsk = FrequencySketch(64), ref.Sketch(64)
    for _, key, _ in ops:
        sk.record(key)
        rsk.record(key)
    assert sk.ages == rsk.ages > 0
    assert [sk.estimate(k) for k in keys] == [rsk.estimate(k) for k in keys]


def test_registry_trace_flight_export(ref, tmp_path):
    rng = np.random.default_rng(4)
    mine, theirs = Registry(source="gateway"), ref.Registry(source="gateway")
    for reg in (mine, theirs):
        reg.counter_add("requests", 3)
        reg.fold_counters({"a": 2, "b": 0}, prefix="x.")
        reg.gauge_set("gateway.queue_depth", 7)
    values = rng.exponential(0.01, HISTOGRAM_CAP + 900).tolist()
    for v in values:  # past the cap: the seeded reservoir samples
        for reg in (mine, theirs):
            reg.observe("gateway.latency_s", v)
            reg.observe("gateway.stage.kernel_dispatch_s", v / 3)
    a, b = mine.snapshot(), theirs.snapshot()
    assert a.as_dict() == b.as_dict()
    assert a.quantile("gateway.latency_s", 99) == \
        b.quantile("gateway.latency_s", 99) > 0
    assert mine.hist_count("gateway.latency_s") == len(values)
    assert a.merged_with(a).as_dict() == b.merged_with(b).as_dict()
    assert a.merge([a, a]).counter("requests") == 6
    assert a.gauge("gateway.queue_depth") == 7.0
    assert export.breakdown_from_snapshot(a) == \
        ref.export.breakdown_from_snapshot(b)
    table = export.render_stage_table(export.breakdown_from_snapshot(a))
    assert table == ref.export.render_stage_table(
        ref.export.breakdown_from_snapshot(b))
    assert export.dominant_stage(export.breakdown_from_snapshot(a)) == \
        "kernel_dispatch"
    # span trees across a thread hand-off, into a private recorder
    rec = flight.FlightRecorder(min_dump_interval_s=60.0,
                                dump_dir=str(tmp_path))
    root = trace.start_span("gw.request", parent=trace.ROOT)
    with trace.use_span(root):
        child = trace.start_span("gw.admission")
        assert trace.current_span() is root
    assert trace.current_span() is None

    def worker():
        trace.start_span("gw.scan_batch", root.context()).finish(
            recorder=rec)

    t = threading.Thread(target=worker, name="shard-x")
    t.start()
    t.join(10)
    child.finish(recorder=rec)
    root.finish(recorder=rec)
    tree = rec.trace_tree(root.trace_id)
    assert [s.name for s in tree][0] == "gw.request" and len(tree) == 3
    assert {s.parent_id for s in tree[1:]} == {root.span_id}
    assert {s.thread for s in tree} >= {"shard-x"}
    first = rec.trip("gateway_timeout", {"x": 1}, tag="shard0")
    assert first and os.path.exists(first)
    assert rec.trip("gateway_timeout") is None  # rate-limited
    events = export.chrome_trace(rec.spans())["traceEvents"]
    assert sum(e["ph"] == "X" for e in events) == 3
    path = export.write_chrome_trace(str(tmp_path / "t.json"), rec.spans())
    assert os.path.getsize(path) > 0
    prev = trace.enable(True)
    assert trace.enabled() and trace.enable(prev)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, ref):
    """One gzip and one uncompressed shard; the reference's index and the
    port's build of the same shards."""
    d = tmp_path_factory.mktemp("torch_serve")
    paths = []
    for i, comp in enumerate(["gzip", "none"]):
        p = str(d / f"s{i}.warc{'.gz' if comp == 'gzip' else ''}")
        write_corpus(p, CorpusSpec(n_pages=6, seed=70 + i), comp)
        paths.append(p)
    return paths, ref.index.build_index(paths), P.build_index(paths,
                                                              device="cpu")


def _request(mod, pattern, regex, flt, top_k):
    filters = None if flt is None else mod.HeaderFilter(**flt)
    return mod.QueryRequest(pattern, filters, top_k=top_k, regex=regex)


def _key(resp):
    return ([(h.index_row, h.shard, h.offset, h.uri, h.n_matches,
              h.positions.tolist(), h.excerpt) for h in resp.hits],
            resp.total_matches)


def _sync(index, req):
    """The port's synchronous engine, ranked like the service."""
    with P.QueryEngine(index, device="cpu") as engine:
        if req.regex:
            hits = engine.search_regex(req.pattern, req.filters)
        else:
            hits = engine.search(req.pattern, req.filters)
    ranked = sorted(hits, key=lambda h: -h.n_matches)
    return _key(SimpleNamespace(hits=ranked[:req.top_k],
                                total_matches=len(hits)))


def _serve_all(gw, requests):
    """Submit every request from 4 client threads at once."""
    with ThreadPoolExecutor(4) as ex:
        futures = list(ex.map(gw.submit, requests))
    return [f.result(300) for f in futures]


@pytest.mark.parametrize("shards", [1, 3])
def test_gateway_matches_reference_and_sync_engine(corpus, ref, shards,
                                                   tmp_path):
    paths, ref_index, port_index = corpus
    mine = [_request(P, *r) for r in REQUESTS] * 2
    theirs = [_request(ref.index, *r) for r in REQUESTS] * 2
    rec = flight.FlightRecorder(dump_dir=str(tmp_path))
    with ArchiveGateway(port_index, shards=shards, device="cpu",
                        flight_recorder=rec) as gw:
        got = _serve_all(gw, mine)
        snap = gw.metrics.snapshot(gw.cache)
    with ref.serve.ArchiveGateway(ref_index, shards=shards) as rgw:
        want = _serve_all(rgw, theirs)
    for req, g, w in zip(mine, got, want):
        assert _key(g) == _key(w) == _sync(port_index, req)
    assert snap["responses"] == len(mine) and snap["errors"] == 0
    assert snap["coalesced"] == snap["requests"] - snap["unique_scans"]
    assert snap["kernel_dispatches"] > 0 and snap["host_scans"] >= 0
    assert snap["latency_p99_ms"] >= snap["latency_p50_ms"] > 0
    assert "kernel_dispatch" in snap["stages"]
    assert snap["cache_hits"] + snap["cache_misses"] > 0
    merged = gw.snapshot()
    assert merged.counter("gateway.responses") == len(mine)
    assert merged.counter("kernel.find_pattern_masks_multi.dispatches") > 0


class _GateEngine(P.QueryEngine):
    """Engine whose ``plan`` parks until released: pins a scan in
    flight, so duplicates deterministically attach to it."""

    def __init__(self, index, **kw):
        super().__init__(index, **kw)
        self.entered = threading.Event()
        self.release = threading.Event()

    def plan(self, *a, **kw):
        self.entered.set()
        assert self.release.wait(60), "the test never released the engine"
        return super().plan(*a, **kw)


def test_coalescing_and_malformed_request_isolation(corpus):
    _, _, port_index = corpus
    engine = _GateEngine(port_index, device="cpu")
    good = P.QueryRequest(b"nginx", top_k=4)
    bad = P.QueryRequest(rb"nginx[(", regex=True)
    other = P.QueryRequest(b"archive", top_k=3)
    with ArchiveGateway(port_index, engine=engine, device="cpu") as gw:
        first = gw.submit(good)
        assert engine.entered.wait(60)  # the scan is executing, parked
        dups = [gw.submit(P.QueryRequest(b"nginx", top_k=4))
                for _ in range(3)]      # attach to the in-flight scan
        bads = [gw.submit(bad), gw.submit(bad)]
        rest = gw.submit(other)
        engine.release.set()
        answers = [f.result(120) for f in [first, *dups]]
        for f in bads:  # the malformed request fails only its own waiters
            with pytest.raises(re.error):
                f.result(120)
        assert _key(rest.result(120)) == _sync(port_index, other)
        snap = gw.metrics.snapshot()
    want = _sync(port_index, good)
    assert all(_key(a) == want for a in answers)
    assert snap["coalesced"] == 4  # 3 attached + 1 duplicate in a batch
    assert snap["errors"] == 1 and snap["responses"] == 5


def test_shard_kill_is_redriven_exactly_once(corpus, ref, tmp_path,
                                            monkeypatch):
    _, _, port_index = corpus
    req = P.QueryRequest(b"nginx", top_k=5)
    want = _sync(port_index, req)
    rec = flight.FlightRecorder(dump_dir=str(tmp_path / "flight"))
    monkeypatch.setattr(archive, "RESPAWN_BACKOFF_S", 0.01)
    with ref.arm_shard_kill(str(tmp_path), nth_batch=1) as latch:
        with ArchiveGateway(port_index, shards=2, device="cpu",
                            flight_recorder=rec) as gw:
            resp = gw.submit(req).result(60)
            assert os.path.exists(latch), "the injected death never fired"
            assert _key(resp) == want
            snap = gw.metrics.snapshot()
            assert (snap["shard_deaths"], snap["shard_respawns"],
                    snap["redriven"], snap["shard_down_errors"]) == (
                1, 1, 1, 0)
            # the dead shard left no launch lock held; the respawned pool
            # keeps serving the same key
            assert not _DISPATCH_LOCK.locked()
            assert _key(gw.submit(req).result(60)) == want
    assert any("shard_down" in p for p in rec.dump_paths)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _multi_inputs(rows: int, width: int, tail: int, seed: int):
    rng = np.random.default_rng(seed)
    m = np.zeros((rows, width + tail), np.uint8)
    live = rows - 1  # the last row stays an inert all-zero pad row
    m[:live, :width] = rng.choice(np.frombuffer(b"WARC/1.\r\n-T", np.uint8),
                                  (live, width))
    m[0, :width] = 0xFF
    pats = np.zeros((rows, 16), np.uint8)
    lens = np.ones(rows, np.int32)
    pats[-1, 0] = 1
    for r in range(live):
        p = PATTERNS[r % len(PATTERNS)]
        pats[r, :len(p)] = np.frombuffer(p, np.uint8)
        lens[r] = len(p)
        for at in (5, 16 - 3, width - len(p), width - 2):  # last: into tail
            m[r, at:min(at + len(p), width)] = pats[r, :min(len(p),
                                                            width - at)]
    return (torch.from_numpy(m).cuda(), torch.from_numpy(pats).cuda(),
            torch.from_numpy(lens).cuda())


@pytest.mark.cuda
def test_cuda_pattern_scan_batch_multi_matches_plain():
    _need_gpu()
    from repro_torch.kernels.pattern_scan import pattern_scan as mod

    for rows, width in ((2, 16), (9, 8192), (48, 24_576)):
        x, p, n = _multi_inputs(rows, width, 16, rows)
        max_len = int(n.max())
        before = mod.multi_launches
        got = mod.pattern_scan_batch_multi(x, p, n, max_len)
        torch.cuda.synchronize()
        assert mod.multi_launches == before + 1
        want = mod.pattern_scan_multi_plain(x, p, n, max_len)
        assert torch.equal(got, want) and int(want.sum()) > 0
    bufs = _scan_rows(5, (0, 5, 100, 200, 255, 256, 500, 700))
    pats = [PATTERNS[i % len(PATTERNS)] for i in range(len(bufs))]
    for g, w in zip(find_pattern_masks_multi(bufs, pats, block=SCAN_BLOCK,
                                             device="cuda"),
                    find_pattern_masks_multi(bufs, pats, block=SCAN_BLOCK,
                                             device="cpu")):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_cuda_pattern_scan_rowgroup_multi_matches_plain():
    _need_gpu()
    from repro_torch.kernels.pattern_scan import pattern_scan as mod

    for rows, width in ((2, 256), (7, 1536), (1024, 2048)):
        x, p, n = _multi_inputs(rows, width, PAD, width)
        max_len = int(n.max())
        before = mod.rowgroup_multi_launches
        got = mod.pattern_scan_rowgroup_multi(x, p, n, max_len)
        torch.cuda.synchronize()
        assert mod.rowgroup_multi_launches == before + 1
        want = mod.pattern_scan_rowgroup_multi_plain(x, p, n, max_len)
        assert torch.equal(got, want) and int(want.sum()) > 0
        m = x.cpu().numpy()
        lengths = np.full(rows - 1, width)
        pats = [PATTERNS[r % len(PATTERNS)] for r in range(rows - 1)]
        np.testing.assert_array_equal(
            find_pattern_masks_multi_rowgroup(m, lengths, pats,
                                              device="cuda"),
            find_pattern_masks_multi_rowgroup(m, lengths, pats,
                                              device="cpu"))
