"""Process-pool slice: ``repro_torch.core.parallel`` and its callers.

The pool's streams equal the serial results (``map_shards``,
``iter_records_parallel`` ordered and unordered, over the ``shm`` and
``pickle`` transports); ``build_index(workers=2)`` on the host path and
with the digest kernel's plain version in the workers gives every CDX
column bit-identical to the JAX reference's serial host build;
``derive(workers=2)`` writes the serial derive's ``.repcol`` bytes; the
supervisor respawns a killed worker once (also one SIGKILLed in the
middle of writing a large result, which an unsupervised pool reports
instead of hanging on) and quarantines a shard that keeps killing
workers; the reaper collects a SIGKILLed worker's segment; one case runs
under ``spawn``, as the GPU path does; concurrent kernel builds compile
each source once (with a stand-in ``nvcc`` here, the real one on the
card).

Every test runs under its own alarm (supervised pools also under
``hang_timeout_s``), so a hang fails in seconds, and leaves no
``/dev/shm`` segment of this process behind. The reference is imported
by a fixture, so the ``cuda`` test also runs where JAX is absent.
"""
import fcntl
import functools
import glob
import importlib
import os
import signal
import struct
import subprocess
import sys
import termios
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.index.cdx as cdx
from repro_torch.columnar import derive
from repro_torch.core import parallel as par
from repro_torch.core.parallel import (ParallelWarcPool, ParallelWorkerError,
                                       iter_records_parallel, map_shards)
from repro_torch.core.reaper import SHM_PREFIX, create_segment, reap_orphans
from repro_torch.core.warc import WarcRecordType
from repro_torch.data.synth import CorpusSpec, write_corpus
from repro_torch.index import build_index
from repro_torch.testing.faults import arm_worker_kill

# the module (the package's ``derive`` name is the function)
derive_mod = importlib.import_module("repro_torch.columnar.derive")
ROOT = Path(__file__).resolve().parents[1]
COLUMNS = ("shard_id", "offset", "comp_len", "uncomp_len", "rtype", "status",
           "digest", "signatures", "frame_off", "frame_base", "uri_off",
           "mime_off")
DEADLINE_S = 45  # per test; the whole file runs in well under a minute


@pytest.fixture(autouse=True)
def deadline():
    """Fail a hung test after ``DEADLINE_S`` and check that it left no
    shared-memory segment of this process behind."""
    def expire(signum, frame):
        raise TimeoutError(f"pool test still running after {DEADLINE_S} s")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)
    assert glob.glob(f"/dev/shm/{SHM_PREFIX}-{os.getpid()}-*") == []


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Three seeded gzip shards of different sizes."""
    d = tmp_path_factory.mktemp("torch_pool")
    paths = []
    for i, pages in enumerate((9, 5, 7)):
        p = str(d / f"s{i}.warc.gz")
        write_corpus(p, CorpusSpec(n_pages=pages, seed=40 + i), "gzip")
        paths.append(p)
    return paths


def _same_columns(got, want) -> None:
    for name in COLUMNS:
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert (got.uri_heap, got.mime_heap) == (want.uri_heap, want.mime_heap)
    assert got.shard_paths == want.shard_paths


# module-level worker functions: picklable for every start method

def _square_slow_head(x):
    if x == 0:
        time.sleep(0.5)  # the first shard finishes last
    return x * x


def _fail_on_three(x):
    if x == 3:
        raise ValueError("bad shard 3")
    return x


def _sweep_or_die(path, **kw):
    """``_index_shard``, except that a poison shard kills its worker, as
    a shard that crashes or exhausts the process would."""
    if "poison" in os.path.basename(path):
        os._exit(77)
    return _ORIG_INDEX_SHARD(path, **kw)


def _extract_or_die(path, **kw):
    if "poison" in os.path.basename(path):
        os._exit(77)
    return _ORIG_EXTRACT(path, **kw)


_ORIG_INDEX_SHARD = cdx._index_shard
_ORIG_EXTRACT = derive_mod._extract_shard


_BIG = 8 << 20  # bytes: a result that fills its pipe many times over


def _big_after_gate(path):
    """``*.big``: wait for the test's ``*.gate`` file, then return
    ``_BIG`` bytes; anything else comes back as it is."""
    if path.endswith(".big"):
        gate = Path(path).with_suffix(".gate")
        while not gate.exists():
            time.sleep(0.01)
        return b"\xab" * _BIG
    return path


def _pending_bytes(conn) -> int:
    return struct.unpack("i", fcntl.ioctl(conn.fileno(), termios.FIONREAD,
                                          b"\0\0\0\0"))[0]


def _kill_mid_write(tmp_path, supervise: bool) -> dict:
    """SIGKILL the worker that is writing a large result while the
    consumer does not read (it holds the event stream between two
    events, so the pipe fills and the write blocks mid-message)."""
    big = tmp_path / f"{supervise}.big"
    items = ["small", str(big)]
    with ParallelWarcPool(functools.partial(par._call_one, _big_after_gate),
                          workers=2, chunk_size=1, transport="pickle",
                          supervise=supervise,
                          hang_timeout_s=20 if supervise else None) as pool:
        events = pool.iter_events(items, ordered=False)
        assert next(events) == ("chunk", 0, ["small"])
        big.with_suffix(".gate").touch()
        deadline = time.monotonic() + 20
        writer = None
        while writer is None and time.monotonic() < deadline:
            # a page or more in one pipe: the large message, still being
            # written (the small shard's messages are a few dozen bytes)
            writer = next((wid for wid, (conn, _) in
                           list(pool._results._pipes.items())
                           if _pending_bytes(conn) >= 4096), None)
            time.sleep(0.01)
        assert writer is not None, "the large result never reached its pipe"
        os.kill(pool._procs[writer].pid, signal.SIGKILL)
        got: dict = {0: "small"}
        try:
            for kind, idx, payload in events:
                if kind == "chunk":
                    got[idx] = payload[0]
        except ParallelWorkerError as exc:
            got["error"] = str(exc)
        return {"got": got, "supervisor": dict(pool.supervisor_stats),
                "partials_dropped": pool.transport_stats["partials_dropped"]}


def _segment_then_sigkill(path):
    """``*.kill``: create a reapable segment, record its name there, die
    by SIGKILL. ``*.watch``: wait until that worker is dead and reaped,
    then report whether its segment outlived it (checked at once: a pool
    that another process starts sweeps orphans too)."""
    kill = Path(path).with_suffix(".kill")
    if path.endswith(".kill"):
        seg = create_segment(4096)
        kill.write_text(seg.name)
        os.kill(os.getpid(), signal.SIGKILL)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        name = kill.read_text() if kill.exists() else ""
        if name:
            pid = int(name[len(SHM_PREFIX) + 1:].split("-")[0])
            try:
                os.kill(pid, 0)  # alive, or a zombie not yet reaped
            except ProcessLookupError:
                return os.path.exists(f"/dev/shm/{name}")
        time.sleep(0.01)
    return None


def test_pool_streams_equal_serial(shards):
    assert map_shards(os.path.getsize, shards, workers=2) == \
        [os.path.getsize(p) for p in shards]
    want = list(iter_records_parallel(shards, workers=0, parse_http=True))

    def key(r):
        return (r.stream_offset, bytes(r.content), r._header_block,
                r.http_content_offset, int(r.record_type))

    assert len(want) > 40
    for transport in ("shm", "pickle"):
        for ordered in (True, False):
            got = list(iter_records_parallel(
                shards, workers=2, parse_http=True, transport=transport,
                ordered=ordered, chunk_size=8))
            if ordered:
                assert [key(r) for r in got] == [key(r) for r in want]
            else:
                assert sorted(map(key, got)) == sorted(map(key, want))
    # chunks larger than a ring slot fall back to the queue, frame-coded
    # chunks as plain pickled ones
    fn = functools.partial(par._extract_records, parse_http=True,
                           types_value=int(WarcRecordType.any_type))
    with ParallelWarcPool(fn, workers=2, chunk_size=1, slot_bytes=4096,
                          frame_codec=(par._encode_record,
                                       par._decode_record)) as pool:
        got = list(pool.iter_results(shards))
        stats = dict(pool.transport_stats)
    assert [key(r) for r in got] == [key(r) for r in want]
    assert stats["queue_chunks"] > 0 and stats["shm_chunks"] > 0


def test_pool_order_under_slow_first_shard():
    items = list(range(8))
    assert map_shards(_square_slow_head, items, workers=3) == \
        [x * x for x in items]
    with ParallelWarcPool(functools.partial(par._call_one,
                                            _square_slow_head),
                          workers=3, chunk_size=1) as pool:
        events = list(pool.iter_events(items, ordered=True))
    assert events == [e for x in items
                      for e in (("chunk", x, [x * x]), ("done", x, 1))]


def test_worker_error_raises_parallel_worker_error():
    with pytest.raises(ParallelWorkerError, match="bad shard 3") as ei:
        map_shards(_fail_on_three, range(6), workers=2)
    assert ei.value.shard_index == 3


@pytest.fixture(scope="module")
def ref_index(shards):
    """The JAX reference's serial host-path build of ``shards``."""
    import repro.index.cdx as R

    return R.build_index(shards, workers=0, fused=False)


def test_build_index_workers_match_reference(shards, ref_index):
    from repro_torch import obs

    assert par._default_context() == "fork"  # no CUDA in this process
    obs.reset()
    serial = build_index(shards, device="cpu")
    buckets = serial.obs.counter("kernel.digest_signature_batch.dispatches")
    assert buckets > 0
    for fused in (None, True):
        obs.reset()
        got = build_index(shards, workers=2, fused=fused, device="cpu")
        _same_columns(got, ref_index)
        assert got.errors == []
        snap = got.obs
        assert {"pool", "worker-0.1", "worker-1.1"} <= set(snap.sources)
        assert snap.counter("index.records") == len(ref_index)
        # the workers' kernel counters arrive once, through their slots
        assert snap.counter("kernel.digest_signature_batch.dispatches") == \
            (buckets if fused else 0)
        assert snap.counter("pool.transport.results") == len(shards)


def test_derive_workers_byte_identical(shards, tmp_path):
    from repro_torch import obs

    serial = derive(shards, str(tmp_path / "a.repcol"), device="cpu")
    obs.reset()
    pooled = derive(shards, str(tmp_path / "b.repcol"), workers=2,
                    supervise=True, device="cpu")
    try:
        assert (tmp_path / "a.repcol").read_bytes() == \
            (tmp_path / "b.repcol").read_bytes()
        assert pooled.errors == [] and serial.errors == []
        assert pooled.obs.counter("pool.transport.results") == len(shards)
        assert pooled.obs.counter("ingest.records") == len(serial)
    finally:
        serial.close()
        pooled.close()
    # the recovering parser in the workers: intact shards, the same bytes
    tolerant = derive(shards, str(tmp_path / "c.repcol"), workers=2,
                      tolerant=True, device="cpu")
    try:
        assert tolerant.errors == []
        assert (tmp_path / "c.repcol").read_bytes() == \
            (tmp_path / "a.repcol").read_bytes()
    finally:
        tolerant.close()


def test_worker_kill_respawns_once(shards, ref_index, tmp_path):
    from repro_torch import obs

    obs.reset()
    with arm_worker_kill(tmp_path, nth=2) as latch:
        got = build_index(shards, workers=2, supervise=True, device="cpu")
        assert os.path.exists(latch)  # the kill fired
    _same_columns(got, ref_index)
    assert got.obs.counter("pool.respawns") == 1
    assert got.obs.counter("pool.quarantined") == 0
    assert got.errors == []
    # killed from outside in the middle of writing a large result: the
    # partial message is dropped, the shard re-driven (supervised) or
    # the death reported (unsupervised) — neither waits forever
    out = _kill_mid_write(tmp_path, supervise=True)
    assert out["got"] == {0: "small", 1: b"\xab" * _BIG}
    assert out["supervisor"] == {"respawns": 1, "quarantined": 0,
                                 "hangs": 0}
    assert out["partials_dropped"] == 1
    out = _kill_mid_write(tmp_path, supervise=False)
    assert "died with exit code(s) [-9]" in out["got"]["error"]
    assert out["partials_dropped"] == 1


def test_poison_shard_quarantined(shards, ref_index, tmp_path, monkeypatch):
    from repro_torch import obs

    poison = str(tmp_path / "poison.warc.gz")
    with open(poison, "wb") as f:
        f.write(b"\x1f\x8b\x08" + b"\x00" * 64)
    items = [shards[0], poison, *shards[1:]]
    assert par._default_context() == "fork"  # the patches reach the workers
    monkeypatch.setattr(cdx, "_index_shard", _sweep_or_die)
    monkeypatch.setattr(derive_mod, "_extract_shard", _extract_or_die)
    parts = map_shards(_extract_or_die, items, workers=2, supervise=True,
                       hang_timeout_s=20, poison_kills=2)
    assert parts[1] is None
    assert [p["path"] for p in parts if p is not None] == shards
    obs.reset()
    got = build_index(items, workers=2, supervise=True, device="cpu")
    _same_columns(got, ref_index)  # the other shards are intact
    assert [(e.shard, e.error_class, e.bytes_skipped) for e in got.errors] \
        == [(poison, "shard_quarantined", 67)]
    assert got.obs.counter("pool.quarantined") == 1
    store = derive(items, str(tmp_path / "p.repcol"), workers=2,
                   supervise=True, device="cpu")
    try:
        assert [(e.shard, e.error_class) for e in store.errors] == \
            [(poison, "shard_quarantined")]
        assert store.shard_paths == shards and len(store) == len(ref_index)
    finally:
        store.close()


def test_reaper_collects_sigkilled_worker_segment(tmp_path):
    kill = str(tmp_path / "a.kill")
    out = map_shards(_segment_then_sigkill, [kill, str(tmp_path / "a.watch")],
                     workers=2, supervise=True, hang_timeout_s=20,
                     poison_kills=1)
    assert out == [None, True], "the segment outlives its SIGKILLed worker"
    name = Path(kill).read_text()
    assert name.startswith(SHM_PREFIX + "-")
    existed = os.path.exists(f"/dev/shm/{name}")
    reaped = reap_orphans()
    assert not os.path.exists(f"/dev/shm/{name}")
    assert name in reaped or not existed  # or another process swept it


def test_spawned_workers_run_the_digest_wrapper(shards, ref_index,
                                                monkeypatch):
    from repro_torch import obs

    monkeypatch.setenv(par.MP_CONTEXT_ENV, "spawn")
    obs.reset()
    got = build_index(shards, workers=2, fused=True, device="cpu")
    _same_columns(got, ref_index)
    assert got.obs.counter("kernel.digest_signature_batch.dispatches") > 0
    assert got.obs.counter("kernel.digest_sig.launches") == 0  # plain: CPU


def test_start_method_rule(monkeypatch):
    monkeypatch.delenv(par.MP_CONTEXT_ENV, raising=False)
    methods = __import__("multiprocessing").get_all_start_methods()
    assert par._default_context() == "fork"
    assert par._default_context(cuda_workers=True) == (
        "forkserver" if "forkserver" in methods else "spawn")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert par._default_context() != "fork"
    monkeypatch.setenv(par.MP_CONTEXT_ENV, "spawn")
    assert par._default_context(cuda_workers=True) == "spawn"


_BUILD_RUN = r"""
import ctypes, sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import _build
_build.BUILD_DIR = Path(sys.argv[2])
libs = sorted(str(p) for p in _build.build_all().values())
if sys.argv[3] == "load":
    for lib in libs:
        ctypes.CDLL(lib)
print(libs)
"""


@pytest.mark.parametrize("compiler", [
    "stand-in", pytest.param("nvcc", marks=pytest.mark.cuda)])
def test_kernel_build_is_safe_across_processes(tmp_path, compiler):
    """Four processes on a cold build directory at once: each source is
    compiled once and each library is whole — with a stand-in ``nvcc``
    that takes a second, or (``cuda``) the toolkit's, each library then
    loaded by every process."""
    from repro_torch.kernels import _build

    if compiler == "nvcc":
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU and its toolkit's nvcc")
        # four cold builds, the flash-attention source ~25 s: past the
        # file's usual deadline
        signal.alarm(300)
        body = f"exec {_build._nvcc()} \"$@\"\n"
    else:
        body = ("while [ $# -gt 0 ]; do\n"
                "  if [ \"$1\" = -o ]; then out=\"$2\"; fi; shift\n"
                "done\n"
                "sleep 1\n"
                "printf whole > \"$out\"\n")
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    calls = tmp_path / "calls"
    nvcc.write_text(f"#!/bin/sh\necho \"$*\" >> {calls}\n" + body)
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"))
    load = "load" if compiler == "nvcc" else "-"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_RUN, str(ROOT / "src"), str(build),
         load], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(4)]
    outs = [p.communicate(timeout=280 if compiler == "nvcc" else 40)
            for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs[0][1][-2000:]
    assert len({o for o, _ in outs}) == 1
    sources = _build._sources()
    assert len(calls.read_text().splitlines()) == len(sources)
    libs = sorted(build.glob("*.so"))
    assert sorted(p.name.split("-")[0] for p in libs) == sorted(sources)
    assert not [p for p in build.iterdir() if ".tmp" in p.name]
    if compiler == "stand-in":
        assert all(p.read_text() == "whole" for p in libs)


@pytest.mark.cuda
def test_cuda_workers_match_cpu(shards):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch import obs

    obs.reset()
    got = build_index(shards, workers=2, fused=True, device="cuda")
    assert got.obs.counter("kernel.digest_sig.launches") > 0
    want = build_index(shards, workers=2, fused=True, device="cpu")
    _same_columns(got, want)
