"""Process-parallel shard ingestion engine.

At Common-Crawl scale one Python process parsing one shard on one core
is the bottleneck; this module fans the shard sweeps out over cores:

* :class:`ParallelWarcPool` — a small process pool purpose-built for
  shard streaming: a lazy task feeder (so infinite shard sequences work),
  a **bounded** result stream (workers block instead of ballooning
  memory), chunked result transfer (amortizes pickling), and an *ordered*
  mode that re-sequences per-shard result streams so consumers see
  exactly the serial order.
* :func:`iter_documents_parallel` — ``iter_documents`` over many shards
  (parse, HTTP decode and HTML→text in the workers).
* :func:`iter_records_parallel` — whole WARC records out of many shards.
* :func:`map_shards` — one-result-per-shard map (map-reduce support;
  ``build_index`` and ``columnar.derive`` merge per-shard partials).

Worker functions must be module-level (picklable) so the pool also works
under the ``spawn`` and ``forkserver`` start methods, which it uses
whenever a worker may touch CUDA or the parent already holds a CUDA
context (:func:`_default_context`).

**Task dealing**: the parent sends each shard down one worker's own task
pipe and records the claim itself at send time (no task queue, and so no
reader lock, shared between processes); a worker that dies holding dealt
shards has every one of them re-driven.

**Result transport**: every worker writes its own result pipe (no lock
shared between processes; see :class:`_ResultInbox`). By default chunks
travel through per-worker ``multiprocessing.shared_memory`` ring slots —
the worker serializes a chunk once into its next free slot
(length-prefixed frames when a ``frame_codec`` is given, one pickle blob
otherwise) and sends only a tiny descriptor through its pipe; the parent
decodes straight out of a zero-copy ``memoryview`` of the slot and
releases it via a semaphore. ``transport="pickle"`` sends every chunk
through the pipe instead, as :func:`map_shards` does.
"""
from __future__ import annotations

import collections
import functools
import os
import pickle
import queue as _queue_mod
import struct
import threading
import time
import traceback
from typing import Any, Callable, Iterable, Iterator

import multiprocessing as mp
from multiprocessing import connection as _mp_connection
from multiprocessing.reduction import ForkingPickler

import torch

from repro_torch import obs
from repro_torch.obs.registry import ObsSnapshot, Registry
from repro_torch.obs.shmstats import (STATS_SLOT_BYTES, StatsSlotReader,
                                      StatsSlotWriter)

from . import reaper as _reaper

try:
    from multiprocessing import shared_memory as _shm_mod
except ImportError:  # pragma: no cover - py>=3.8 everywhere we run
    _shm_mod = None

__all__ = [
    "ParallelWarcPool",
    "ParallelWorkerError",
    "iter_documents_parallel",
    "iter_records_parallel",
    "map_shards",
]

_CHUNK = 0       # payload: list of results
_DONE = 1        # payload: number of results produced for the task
_ERROR = 2       # payload: (repr(exc), formatted traceback)
_CHUNK_SHM = 3   # payload: (worker_id, slot, nbytes, count) ring descriptor
_CHUNK_BLOB = 4  # payload: pickled chunk bytes (ring-overflow fallback)
_QUAR = 5        # synthetic, parent-side only: shard quarantined as poison

_DEFAULT_CHUNK_SIZE = 64
_DEAL_DEPTH = 2             # shards dealt to a worker and not yet done
_TASK_PIPE_SAFE = 16 << 10  # a task this large goes only to an idle worker
_SHM_SLOT_BYTES = 4 << 20   # per-slot capacity; larger chunks fall back
_SHM_SLOTS = 4              # slots per worker (in-flight chunk window)
_PICKLE_MARK = 0xFFFFFFFF   # frame-count marker: slot holds one pickle blob

#: Start-method override (``fork``, ``spawn`` or ``forkserver``).
MP_CONTEXT_ENV = "REPRO_TORCH_MP_CONTEXT"
#: Fault injection: ``"<latch-path>:<N>"`` kills one worker before its
#: ``N``-th result (:func:`repro_torch.testing.faults.arm_worker_kill`).
FAULT_WORKER_KILL_ENV = "REPRO_TORCH_FAULT_WORKER_KILL"


class ParallelWorkerError(RuntimeError):
    """A worker process raised while processing a shard."""

    def __init__(self, shard_index: int, message: str, worker_traceback: str):
        super().__init__(
            f"shard #{shard_index}: {message}\n--- worker traceback ---\n"
            f"{worker_traceback}")
        self.shard_index = shard_index


_MSG_LEN = struct.Struct("<Q")   # result-pipe message header: byte count
_READ_BYTES = 1 << 20             # parent: most bytes read from a pipe at once


def _send_msg(fd: int, msg) -> None:
    """Worker side: pickle ``msg`` and write it whole, length-prefixed,
    to this worker's own result pipe before returning."""
    data = ForkingPickler.dumps(msg)
    for part in (_MSG_LEN.pack(len(data)), data):
        view = memoryview(part)
        while view:
            view = view[os.write(fd, view):]


class _ResultInbox:
    """Parent side of the worker → parent messages: one pipe per worker
    incarnation, read without ever blocking inside a message.

    ``multiprocessing.Queue`` hands every ``put`` to a feeder thread that
    writes one pipe under a lock shared by **all** writer processes. A
    worker that exits while its feeder thread holds that lock — a poison
    shard's ``os._exit`` in the main thread, the injected worker kill,
    any crash right after a result was queued — leaves the lock held
    forever: every other worker blocks on it, and the parent polls for
    results that never come (the supervised pool's hang). Here each
    worker writes its own pipe from its own thread (:func:`_send_msg`),
    so no lock is shared between processes. The parent closes its copy
    of a pipe's write end once the worker has started, reads whatever
    bytes are ready and cuts them into messages itself: a worker killed
    in the middle of a write (the OOM killer, during a 15 MB partial)
    ends its pipe with a partial message, which is dropped and counted
    (``partials_dropped``), and a worker stuck mid-write cannot hold the
    parent past the supervisor's hang timeout. Flow control is the
    per-worker credit semaphores (and each pipe's own capacity).
    """

    def __init__(self, ctx, stats: dict) -> None:
        self._ctx = ctx
        self._stats = stats
        self._pipes: dict[int, tuple] = {}  # wid -> (reader, bytearray)
        self._ready: collections.deque = collections.deque()

    def open(self, wid: int):
        """A fresh pipe for worker ``wid``; returns the write end, which
        the caller hands to the worker and then closes."""
        assert wid not in self._pipes, "the previous incarnation's pipe is open"
        reader, writer = self._ctx.Pipe(duplex=False)
        os.set_blocking(reader.fileno(), False)
        self._pipes[wid] = (reader, bytearray())
        return writer

    def is_open(self, wid: int) -> bool:
        """False once worker ``wid``'s pipe reached its end: every whole
        message it sent has been read."""
        return wid in self._pipes

    def _pump(self, timeout: float) -> None:
        if not self._pipes:
            time.sleep(timeout)
            return
        owner = {conn: wid for wid, (conn, _) in self._pipes.items()}
        for conn in _mp_connection.wait(list(owner), timeout):
            self._read(owner[conn])

    def _read(self, wid: int) -> None:
        conn, buf = self._pipes[wid]
        while True:
            try:
                data = os.read(conn.fileno(), _READ_BYTES)
            except BlockingIOError:
                return
            if not data:  # every writer is gone
                if buf:
                    self._stats["partials_dropped"] += 1
                conn.close()
                del self._pipes[wid]
                return
            buf += data
            while len(buf) >= _MSG_LEN.size:
                (n,) = _MSG_LEN.unpack_from(buf)
                end = _MSG_LEN.size + n
                if len(buf) < end:
                    break
                self._ready.append(bytes(buf[_MSG_LEN.size:end]))
                del buf[:end]
            if self._ready:
                return  # hand whole messages on before reading more

    def get(self, timeout: float):
        """Next message; raises ``queue.Empty`` after ``timeout`` s."""
        deadline = time.monotonic() + timeout
        while not self._ready:
            left = deadline - time.monotonic()
            if left <= 0:
                raise _queue_mod.Empty
            self._pump(left)
        return ForkingPickler.loads(self._ready.popleft())

    def empty(self) -> bool:
        """No whole message is waiting and no pipe has bytes or its end
        to read; a dead worker's pipe stays readable until its end is
        read."""
        if self._ready:
            return False
        conns = [conn for conn, _ in self._pipes.values()]
        return not conns or not _mp_connection.wait(conns, 0)

    def close(self) -> None:
        for conn, _ in self._pipes.values():
            conn.close()
        self._pipes.clear()
        self._ready.clear()


class _ShmSlotWriter:
    """Worker-side ring writer over one shared-memory segment.

    The segment is divided into fixed slots used round-robin; a
    semaphore (initially ``slots``) gates writes: the parent releases it
    after decoding a slot, and because the parent consumes descriptors
    in FIFO order, when ``acquire`` returns the round-robin target slot
    is always the oldest — already drained — one.
    """

    def __init__(self, name: str, slot_bytes: int, slots: int, sem,
                 worker_id: int) -> None:
        # the parent owns the segment's lifetime: attaching must not
        # (re-)register it with a resource tracker, or a tracker would
        # unlink it on child exit (spawn) / complain about the parent's
        # own unlink (fork, shared tracker) — py3.13 grew track=False
        # for exactly this; on 3.10 the registration hook is stubbed out
        # around the attach instead
        from multiprocessing import resource_tracker

        orig_register = resource_tracker.register
        resource_tracker.register = lambda *a, **k: None
        try:
            self._shm = _shm_mod.SharedMemory(name=name)
        finally:
            resource_tracker.register = orig_register
        self._slot_bytes = slot_bytes
        self._slots = slots
        self._sem = sem
        self._next = 0
        self.worker_id = worker_id

    def try_send(self, put, idx: int, frames, blob) -> bool:
        """Write one serialized chunk into the next free slot; False if it
        cannot fit (caller falls back to the pipe)."""
        if frames is not None:
            nbytes = sum(4 + len(f) for f in frames)
            count = len(frames)
        else:
            nbytes = len(blob)
            count = _PICKLE_MARK
        if nbytes > self._slot_bytes:
            return False
        self._sem.acquire()
        slot = self._next
        self._next = (slot + 1) % self._slots
        off = slot * self._slot_bytes
        buf = self._shm.buf
        if frames is not None:
            for f in frames:
                struct.pack_into("<I", buf, off, len(f))
                off += 4
                buf[off:off + len(f)] = f
                off += len(f)
        else:
            buf[off:off + nbytes] = blob
        put((idx, _CHUNK_SHM, (self.worker_id, slot, nbytes, count)))
        return True

    def close(self) -> None:
        try:
            self._shm.close()
        except OSError:  # pragma: no cover - teardown race
            pass


class _WorkerStatsPublisher:
    """Worker-side observability publisher over one seqlock stats slot.

    Installs a **fresh** process-default :class:`Registry` (a forked
    worker inherits the parent's counters — publishing those back would
    double-count them on merge) and pickles cumulative snapshots into
    this worker's slot of the parent-owned stats segment after every
    completed shard. The parent harvests whenever it likes; because it
    owns the segment, a SIGKILLed worker's last publish survives it.
    """

    def __init__(self, name: str, offset: int, source: str) -> None:
        # parent owns the segment: attach without (re-)registering, same
        # rationale as _ShmSlotWriter
        from multiprocessing import resource_tracker

        orig_register = resource_tracker.register
        resource_tracker.register = lambda *a, **k: None
        try:
            self._shm = _shm_mod.SharedMemory(name=name)
        finally:
            resource_tracker.register = orig_register
        self._view = self._shm.buf[offset:offset + STATS_SLOT_BYTES]
        self._writer = StatsSlotWriter(self._view)
        obs.set_registry(Registry(source=source))

    def publish(self) -> None:
        self._writer.publish(obs.snapshot())

    def close(self) -> None:
        self.publish()
        self._writer.close()
        self._view.release()  # exports must be gone before shm.close()
        try:
            self._shm.close()
        except OSError:  # pragma: no cover - teardown race
            pass


def _maybe_worker_kill(counter: int, spec: str | None) -> None:
    """Fault-injection hook: die hard before sending result ``N``.

    Armed through ``REPRO_TORCH_FAULT_WORKER_KILL="<latch-path>:<N>"``; the
    latch file is claimed with ``O_CREAT|O_EXCL`` so exactly one worker
    across the whole (fork or spawn) pool dies, exactly once — the
    supervision tests depend on deterministic single-kill behavior.

    ``spec`` is captured from the *parent's* environment at worker-spawn
    time and passed down explicitly rather than read from the worker's
    own ``os.environ``: under the forkserver start method every worker
    forks from a daemon that snapshotted the environment when it first
    started, so a worker's environment can be armed long after the test
    that armed it disarmed and deleted its latch (replaying the kill
    into an innocent pool) — or never armed at all.
    """
    if not spec:
        return
    latch, _, at = spec.rpartition(":")
    if counter != int(at):
        return
    try:
        fd = os.open(latch, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except OSError:  # another worker already took the kill
        return
    os.close(fd)
    os._exit(42)


def _worker_loop(task_conn, result_conn, worker_fn, chunk_size: int,
                 shm_args=None, encode=None, wid: int = 0,
                 hb=None, stop_ev=None, claims=None, credit=None,
                 fault_kill: str | None = None,
                 stats_args=None) -> None:
    """Child-process main: read ``(idx, item, skip)`` tasks from this
    worker's own task pipe (``task_conn``, the read end: the parent deals
    every task and records the claim itself when it sends it) and stream
    worker_fn(item) results back in chunks through this worker's own
    result pipe (``result_conn``, the write end; see :class:`_ResultInbox`).

    The loop polls its task pipe and stops when ``stop_ev`` is set or its
    parent is gone. In supervised pools it stamps a heartbeat (``hb``, a
    shared double) whenever it makes progress and marks the task it
    starts in ``claims[wid]`` — which shard a death is blamed on, and
    what the hang detector watches; a death before that mark re-drives
    the shard all the same, blamelessly. Every task carries a resume
    cursor: ``skip`` results are suppressed — exactly the slice the
    parent already holds of a re-driven shard.

    ``credit`` is this worker's result-credit semaphore: acquired
    before every message, released by the parent per message received —
    the backpressure that bounds each worker's unread messages (4 ×
    workers). Per-worker credits (not a pool-wide bound) let the
    supervisor drain-and-refill a dead worker's semaphore back to
    exactly its cap. Every message is tagged with ``wid`` so the
    parent knows whose credit to return.
    """
    # one process, one core: torch's intra-op thread pool would
    # oversubscribe the host, and a forked copy of the parent's pool is
    # not safe to use
    torch.set_num_threads(1)
    writer = None
    if shm_args is not None and _shm_mod is not None:
        try:
            writer = _ShmSlotWriter(*shm_args)
        except Exception:  # segment vanished: send chunks through the pipe
            writer = None
    stats_pub = None
    if stats_args is not None and _shm_mod is not None:
        try:
            stats_pub = _WorkerStatsPublisher(*stats_args)
        except Exception:  # segment vanished: run without obs publishing
            stats_pub = None

    def beat() -> None:
        if hb is not None:
            hb.value = time.monotonic()

    ppid = os.getppid()

    def orphaned() -> bool:
        # the pool's owner (or, under forkserver, the server it started)
        # is gone without a close(): SIGKILL, os._exit. Nobody will ever
        # stop this worker, so it stops itself.
        return os.getppid() != ppid

    sent_total = 0
    result_fd = result_conn.fileno()

    def put(msg) -> None:
        while not credit.acquire(timeout=0.2):
            beat()  # backpressure stall, not a hang
            if stop_ev is not None and stop_ev.is_set() or orphaned():
                return  # parent is tearing down; message is moot
        _send_msg(result_fd, msg + (wid,))

    def send(idx: int, buf: list) -> None:
        if writer is None:
            put((idx, _CHUNK, buf))
            return
        # serialize exactly once; an over-slot chunk reuses the blob via
        # the pipe (no re-pickling), frames fall back to a plain chunk
        frames = blob = None
        if encode is not None:
            frames = [encode(item) for item in buf]
        else:
            blob = pickle.dumps(buf, protocol=pickle.HIGHEST_PROTOCOL)
        if writer.try_send(put, idx, frames, blob):
            return
        if blob is not None:
            put((idx, _CHUNK_BLOB, blob))
        else:
            put((idx, _CHUNK, buf))

    try:
        while True:
            if not task_conn.poll(0.25):
                beat()
                if stop_ev.is_set() or orphaned():
                    return
                continue
            try:
                idx, item, skip = ForkingPickler.loads(
                    task_conn.recv_bytes())
            except EOFError:  # the parent closed this worker's task pipe
                return
            if claims is not None:
                claims[wid] = idx
            beat()
            try:
                buf: list = []
                produced = 0
                seen = 0
                for out in worker_fn(item):
                    seen += 1
                    if seen <= skip:
                        continue
                    sent_total += 1
                    _maybe_worker_kill(sent_total, fault_kill)
                    buf.append(out)
                    if len(buf) >= chunk_size:
                        send(idx, buf)
                        produced += len(buf)
                        buf = []
                        beat()
                if buf:
                    send(idx, buf)
                    produced += len(buf)
                # publish (per shard, never per record) before the _DONE:
                # once the parent holds every _DONE the stream is over
                # and close() may terminate this worker at any moment
                if stats_pub is not None:
                    stats_pub.publish()
                put((idx, _DONE, skip + produced))
                beat()
            except Exception as exc:  # surfaced as ParallelWorkerError
                if stats_pub is not None:
                    stats_pub.publish()
                put((idx, _ERROR, (repr(exc), traceback.format_exc())))
    finally:
        if stats_pub is not None:
            stats_pub.close()
        if writer is not None:
            writer.close()


def _default_context(cuda_workers: bool = False) -> str:
    """The start method for a new pool.

    ``fork`` is much cheaper to start, but a CUDA context does not
    survive a fork: a child forked from a process whose context is live
    inherits its CUDA threads and locks in an unknown state and cannot
    use CUDA at all. So ``fork`` is used only while the parent holds no
    CUDA context **and** the workers will not touch CUDA
    (``cuda_workers``); otherwise ``forkserver`` (children fork from a
    clean server process that never touches CUDA, and each may open its
    own context) or, where that is missing, ``spawn``.
    ``REPRO_TORCH_MP_CONTEXT`` overrides.
    """
    override = os.environ.get(MP_CONTEXT_ENV)
    if override:
        return override
    methods = mp.get_all_start_methods()
    if ("fork" in methods and not cuda_workers
            and not torch.cuda.is_initialized()):
        return "fork"
    for method in ("forkserver", "spawn"):
        if method in methods:
            return method
    return "fork"


class ParallelWarcPool:
    """Process pool streaming per-shard results through bounded queues.

    Parameters
    ----------
    worker_fn:
        module-level callable; ``worker_fn(item)`` returns/yields the
        results for one shard. Use ``functools.partial`` for options.
    workers:
        process count (default: ``os.cpu_count()``).
    chunk_size:
        results per message (pickling amortization).
    mp_context:
        multiprocessing start method ("fork"/"spawn"/"forkserver");
        default from ``REPRO_TORCH_MP_CONTEXT``, else
        :func:`_default_context`: fork unless CUDA is involved.
    cuda_workers:
        the workers launch CUDA kernels: never fork them.
    transport:
        ``"shm"`` (default where available) streams result chunks
        through per-worker shared-memory ring slots — no pipe copies;
        ``"pickle"`` sends every chunk through the worker's pipe. Chunks
        that overflow a ring slot (``slot_bytes``) fall back to the pipe.
    frame_codec:
        optional ``(encode, decode)`` pair of **module-level** functions
        for the shm transport: ``encode(result) -> bytes`` and
        ``decode(memoryview) -> result``. With a codec, results cross
        the process boundary as length-prefixed frames and are decoded
        straight from the shared-memory view — no pickling at all.
        Without one, shm slots carry a single pickle blob (still
        skipping the pipe).
    supervise:
        enable the fault-tolerance supervisor: workers stamp heartbeats
        and mark the shard they start; the parent detects dead children
        (exitcode) and — with ``hang_timeout_s`` — hung ones (stale
        heartbeat while holding a task), reaps/reset their ring
        semaphore, respawns with capped exponential backoff, and
        **re-drives every shard it dealt the dead worker and has not seen
        done**, each from its unfinished slice (the worker skips exactly
        the results the parent already decoded): a kill at any moment —
        mid-shard, between reading a task and starting it, idle in the
        task read — loses nothing and blocks no other worker. A shard that kills
        ``poison_kills`` workers is quarantined: the event stream emits
        ``("quarantined", idx, reason)`` instead of hanging or raising.
        Worker *exceptions* still raise :class:`ParallelWorkerError` —
        supervision retries process deaths, not bugs.
    max_respawns:
        total respawn budget for non-quarantine deaths; exceeding it
        raises (a crash-looping environment must not retry forever).
    """

    def __init__(self, worker_fn: Callable[[Any], Iterable],
                 *, workers: int | None = None,
                 chunk_size: int = _DEFAULT_CHUNK_SIZE,
                 mp_context: str | None = None,
                 transport: str | None = None,
                 frame_codec: tuple[Callable, Callable] | None = None,
                 slot_bytes: int = _SHM_SLOT_BYTES,
                 supervise: bool = False,
                 max_respawns: int = 3,
                 hang_timeout_s: float | None = None,
                 poison_kills: int = 2,
                 cuda_workers: bool = False) -> None:
        self.workers = max(1, workers if workers else (os.cpu_count() or 1))
        self._ctx = mp.get_context(mp_context
                                   or _default_context(cuda_workers))
        if self._ctx.get_start_method() == "forkserver":
            # the server imports torch (and this module, where its path
            # is known there) once, before its first fork: by default it
            # preloads nothing, and every worker would import torch
            # anew, as under spawn (seconds each). A no-op once this
            # process's server runs.
            self._ctx.set_forkserver_preload(["torch", __name__])
        # unread result messages allowed per worker: the backpressure
        # that keeps workers from buffering a whole crawl in the parent
        self._queue_chunks = 4 * self.workers
        self._credits = [self._ctx.Semaphore(self._queue_chunks)
                         for _ in range(self.workers)]
        # shards waiting to be dealt: re-driven ones (a supervisor tick's
        # (idx, item, skip)) go first, then the feeder's (idx, item).
        # Only the event loop deals (_deal), never blocking on a worker:
        # a parent blocked on a send would stop reading results, and a
        # worker waiting for a result credit would never read its task
        self._requeues: collections.deque = collections.deque()
        self._backlog: collections.deque = collections.deque()
        # per worker: the parent-side end of its task pipe, and the shards
        # dealt to it and not yet done (idx -> item), in dealing order
        self._task_conns: list = [None] * self.workers
        self._dealt: list[dict] = [{} for _ in range(self.workers)]
        self._stop = threading.Event()
        self._feed_done = threading.Event()
        self._total: int | None = None
        self._feed_error: BaseException | None = None
        self._feeder: threading.Thread | None = None
        self._progress = 0          # consumer's cur (ordered mode)
        self._window: int | None = None  # max shards fed ahead of progress
        self.supervise = bool(supervise)
        self.max_respawns = max_respawns
        self.hang_timeout_s = hang_timeout_s
        self.poison_kills = poison_kills
        self._stop_ev = self._ctx.Event()
        self._claims = (self._ctx.Array("q", [-1] * self.workers, lock=False)
                        if supervise else None)
        self._respawns = 0
        self._synthetic: collections.deque = collections.deque()
        self.supervisor_stats = {"respawns": 0, "quarantined": 0, "hangs": 0}
        requested = transport
        if transport is None:
            transport = "shm" if _shm_mod is not None else "pickle"
        if transport not in ("shm", "pickle"):
            raise ValueError(f"unknown transport {transport!r}")
        if transport == "shm" and _shm_mod is None:  # pragma: no cover
            transport = "pickle"
        self._decode = frame_codec[1] if frame_codec else None
        self._slot_bytes = slot_bytes
        self._segments: list = []
        self._sems: list = []
        self._procs: list = []
        self._stats_seg = None
        self._stats_gen = [0] * self.workers   # per-wid incarnation counter
        self._worker_snaps: dict[str, ObsSnapshot] = {}
        self._stats_absorbed = False
        self._closed = False  # before any allocation: __del__ must be safe
        self.transport_stats = {"shm_chunks": 0, "shm_bytes": 0,
                                "queue_chunks": 0, "results": 0,
                                "partials_dropped": 0}
        self._results = _ResultInbox(self._ctx, self.transport_stats)
        if transport == "shm":
            # tmpfs-backed: a constrained /dev/shm (docker's 64 MB default
            # with several 16 MiB rings) makes allocation fail — the
            # *default* transport must degrade to the pipe, not
            # crash ingestion; an explicit transport="shm" still raises
            try:
                for _ in range(self.workers):
                    self._segments.append(
                        _reaper.create_segment(slot_bytes * _SHM_SLOTS))
                    self._sems.append(self._ctx.Semaphore(_SHM_SLOTS))
            except OSError:
                for seg in self._segments:
                    try:
                        seg.close()
                        seg.unlink()
                        _reaper.unregister(seg)
                    except OSError:  # pragma: no cover - teardown race
                        pass
                self._segments = []
                self._sems = []
                if requested == "shm":
                    raise
                transport = "pickle"
        self.transport = transport
        # one seqlock stats slot per worker: workers publish cumulative
        # ObsSnapshots here after every shard; the parent harvests on
        # supervisor ticks and close(). Optional — a
        # constrained /dev/shm degrades to no worker stats, not a crash.
        if _shm_mod is not None:
            try:
                self._stats_seg = _reaper.create_segment(
                    STATS_SLOT_BYTES * self.workers)
            except OSError:
                self._stats_seg = None
        self._worker_fn = worker_fn
        self._chunk_size = chunk_size
        self._encode = frame_codec[0] if frame_codec else None
        self._hb = ([self._ctx.Value("d", 0.0, lock=False)
                     for _ in range(self.workers)] if supervise else [])
        for wid in range(self.workers):
            self._procs.append(self._make_worker(wid))

    def _make_worker(self, wid: int):
        """Spawn (or respawn) worker ``wid``; reuses its ring segment."""
        shm_args = None
        if self.transport == "shm":
            shm_args = (self._segments[wid].name, self._slot_bytes,
                        _SHM_SLOTS, self._sems[wid], wid)
        hb = None
        if self.supervise:
            hb = self._hb[wid]
            hb.value = time.monotonic()
        stats_args = None
        if self._stats_seg is not None:
            # incarnation-tagged source: a respawned worker publishes
            # under a fresh key, so the dead incarnation's harvested
            # snapshot survives the slot being overwritten
            self._stats_gen[wid] += 1
            stats_args = (self._stats_seg.name, wid * STATS_SLOT_BYTES,
                          f"worker-{wid}.{self._stats_gen[wid]}")
        writer = self._results.open(wid)
        task_reader, task_writer = self._ctx.Pipe(duplex=False)
        if self._task_conns[wid] is not None:
            self._task_conns[wid].close()  # the dead incarnation's
        self._task_conns[wid] = task_writer
        p = self._ctx.Process(
            target=_worker_loop,
            args=(task_reader, writer, self._worker_fn,
                  self._chunk_size, shm_args, self._encode, wid, hb,
                  self._stop_ev, self._claims, self._credits[wid],
                  os.environ.get(FAULT_WORKER_KILL_ENV), stats_args),
            daemon=True)
        p.start()
        # the worker holds the write end now: its exit ends the pipe; and
        # the task pipe's read end is its alone
        writer.close()
        task_reader.close()
        return p

    # -- shm decode ------------------------------------------------------
    def _decode_slot(self, desc: tuple) -> list:
        """Materialize one ring slot's chunk from a zero-copy view and
        hand the slot back to its worker."""
        wid, slot, nbytes, count = desc
        view = self._segments[wid].buf[slot * self._slot_bytes:
                                       slot * self._slot_bytes + nbytes]
        try:
            if count == _PICKLE_MARK:
                results = pickle.loads(view)
            else:
                results = []
                off = 0
                decode = self._decode
                for _ in range(count):
                    (flen,) = struct.unpack_from("<I", view, off)
                    off += 4
                    results.append(decode(view[off:off + flen]))
                    off += flen
        finally:
            del view  # release the buffer export before the slot recycles
            # hand the slot back even when decode raises: a leaked permit
            # would deadlock the worker's ring on a later event stream
            self._sems[wid].release()
        self.transport_stats["shm_chunks"] += 1
        self.transport_stats["shm_bytes"] += nbytes
        return results

    # -- task feeding ----------------------------------------------------
    def _feed(self, items: Iterable) -> None:
        """Feeder thread: pull ``items`` (possibly lazy and endless) into
        the backlog the event loop deals from, a few shards ahead."""
        count = 0
        try:
            for idx, item in enumerate(items):
                # ordered mode: don't run ahead of the consumer by more
                # than a window of shards — otherwise every faster shard's
                # full output piles up in the consumer's `pending` buffer
                # (unbounded memory) while one slow shard holds `cur`
                while ((len(self._backlog) >= 2 * self.workers or (
                        self._window is not None
                        and idx - self._progress > self._window))
                       and not self._stop.is_set()):
                    time.sleep(0.01)
                if self._stop.is_set():
                    return
                self._backlog.append((idx, item))
                count = idx + 1
        except BaseException as exc:  # surfaced by iter_events, not swallowed
            self._feed_error = exc
        finally:
            self._total = count
            self._feed_done.set()

    def _deal(self) -> None:
        """Send waiting shards, re-driven ones first, to live workers
        with fewer than ``_DEAL_DEPTH`` shards outstanding, recording
        each claim before its send. Dealing is breadth-first: every
        worker gets its first shard before any gets a second, so N
        shards over W <= N workers keep all W busy. A task past
        ``_TASK_PIPE_SAFE`` bytes goes only to a worker with nothing
        outstanding (it reads at once), so a send never blocks the
        event loop."""
        for depth in range(_DEAL_DEPTH):
            for wid in range(self.workers):
                if not (self._requeues or self._backlog):
                    return
                dealt = self._dealt[wid]
                if (len(dealt) > depth
                        or self._procs[wid].exitcode is not None):
                    continue
                requeued = bool(self._requeues)
                idx, item, *rest = (self._requeues[0] if requeued
                                    else self._backlog[0])
                skip = rest[0] if rest else 0
                data = ForkingPickler.dumps((idx, item, skip))
                if dealt and len(data) > _TASK_PIPE_SAFE:
                    continue
                (self._requeues if requeued else self._backlog).popleft()
                dealt[idx] = item  # the claim, before the send
                try:
                    self._task_conns[wid].send_bytes(data)
                except OSError:
                    # the worker is gone: its claims are re-driven (or
                    # the stream fails) once its death is seen
                    continue

    # -- observability ---------------------------------------------------
    def _harvest_worker_stats(self) -> None:
        """Read every worker's latest published snapshot into
        ``self._worker_snaps``, keyed by incarnation source
        (``worker-<wid>.<gen>``) so a dead worker's harvest survives its
        replacement reusing the slot. Cheap enough for supervisor ticks:
        snapshots are a few KiB of counters per worker."""
        if self._stats_seg is None:
            return
        for wid in range(self.workers):
            view = self._stats_seg.buf[wid * STATS_SLOT_BYTES:
                                       (wid + 1) * STATS_SLOT_BYTES]
            reader = StatsSlotReader(view)
            snap = reader.read()
            reader.close()
            view.release()  # export gone before any close/unlink
            if snap is not None and snap.sources:
                self._worker_snaps[snap.sources[0]] = snap

    def _absorb_stats(self) -> None:
        """Fold the pool's own counters (``pool.transport.*``,
        ``pool.{respawns,quarantined,hangs}``, and the gauge
        ``pool.transport.shm``: 1 for the ring slots, 0 for the pipe)
        plus every harvested worker snapshot into the process-default
        registry, exactly once (from ``close()``): after it,
        ``obs.snapshot()`` alone is the whole tree's truth. Counters are
        cumulative, so the guard is what keeps a double ``close()`` from
        double-counting."""
        if self._stats_absorbed:
            return
        self._stats_absorbed = True
        reg = obs.registry()
        reg.fold_counters({f"pool.transport.{k}": int(v)
                           for k, v in self.transport_stats.items()})
        reg.fold_counters({f"pool.{k}": int(v)
                           for k, v in self.supervisor_stats.items()})
        reg.gauge_set("pool.transport.shm", float(self.transport == "shm"))
        reg.attach_source("pool")
        for src in sorted(self._worker_snaps):
            reg.absorb(self._worker_snaps[src])

    # -- supervision -----------------------------------------------------
    def _supervise_tick(self, received: dict, kills: dict, terminal: set,
                        backoff: float) -> float:
        """Detect dead/hung workers; reap, respawn, re-drive, quarantine.

        Runs only from the event loop's idle branch *and* only when no
        result is waiting, and acts on a dead worker only once its result
        pipe has reached its end: every message it managed to deliver has
        been decoded (and its ring slot released) before we compute the
        resume cursor, so ``received[idx]`` is exact. What to re-drive
        comes from the parent's own record of the shards it dealt the
        worker; the shared claims array says only which of them the
        worker had started — the one a death is blamed on.
        """
        # harvest first: a dead worker's last published counters must be
        # captured before its replacement starts overwriting the slot
        self._harvest_worker_stats()
        now = time.monotonic()
        for wid, p in enumerate(self._procs):
            claim = self._claims[wid]
            dealt = self._dealt[wid]
            holds_task = claim >= 0 and claim in dealt
            if (p.exitcode is None and self.hang_timeout_s is not None
                    and holds_task
                    and now - self._hb[wid].value > self.hang_timeout_s):
                # holds a task but hasn't made progress: stuck inside
                # worker_fn (idle workers heartbeat every poll timeout)
                self.supervisor_stats["hangs"] += 1
                p.terminate()
                p.join(timeout=1.0)
                if p.exitcode is None:  # pragma: no cover - SIGTERM masked
                    p.kill()
                    p.join(timeout=1.0)
            if p.exitcode is None or self._results.is_open(wid):
                continue  # alive, or its last messages are still unread
            # any exit while the stream runs is abnormal: supervised
            # workers only return after close() sets the stop event
            idx = claim if holds_task else None
            # every whole message the worker sent has been read (its
            # pipe ended; a partial last one was dropped), so every shard
            # dealt to it and not done owes the parent data: re-drive it
            # — blameless unless it is the one the worker had started
            lost = {i: item for i, item in dealt.items() if i != idx}
            quarantine = False
            if idx is not None:
                kills[idx] = kills.get(idx, 0) + 1
                quarantine = kills[idx] >= self.poison_kills
            if not quarantine:
                if self._respawns >= self.max_respawns:
                    raise ParallelWorkerError(
                        -1 if idx is None else idx,
                        f"worker {wid} died (exit {p.exitcode}) with "
                        f"respawn budget ({self.max_respawns}) exhausted",
                        "")
                self._respawns += 1
            self.supervisor_stats["respawns"] += 1
            time.sleep(backoff)
            backoff = min(backoff * 2.0, 1.0)
            if self.transport == "shm":
                # a kill between sem.acquire and the descriptor put
                # leaks a permit; the pipe-end guard above means
                # every delivered slot was decoded and released, so
                # draining and refilling restores exactly `slots`
                sem = self._sems[wid]
                while sem.acquire(False):
                    pass
                for _ in range(_SHM_SLOTS):
                    sem.release()
            # same repair for the result credits: a credit taken for a
            # message the worker died before sending never comes back by
            # itself. The worker is fully dead (exitcode reaped) and its
            # pipe has ended, so every message it sent whole was already
            # credited back — the refill is exact, not approximate.
            credit = self._credits[wid]
            while credit.acquire(False):
                pass
            for _ in range(self._queue_chunks):
                credit.release()
            self._claims[wid] = -1  # the requeues below own the shards now
            self._dealt[wid] = {}
            self._procs[wid] = self._make_worker(wid)
            if quarantine:
                self.supervisor_stats["quarantined"] += 1
                self._synthetic.append((idx, _QUAR,
                                        f"shard killed {kills[idx]} "
                                        f"worker(s); quarantined"))
            elif idx is not None:
                lost[idx] = dealt[idx]
            # in dealing order: an earlier shard holds the ordered cursor
            for i in sorted(lost):
                self._requeues.append((i, lost[i], received.get(i, 0)))
        return backoff

    # -- event stream ----------------------------------------------------
    def iter_events(self, items: Iterable, *,
                    ordered: bool = True) -> Iterator[tuple]:
        """Stream ``("chunk", idx, results)`` / ``("done", idx, n)`` events.

        ``idx`` is the shard's enumeration index in ``items``. In ordered
        mode events are re-sequenced to exactly the serial order (chunks
        of shard *i* complete — ``("done", i, n)`` — before anything of
        shard *i+1* appears); unordered mode streams events as workers
        finish, which is faster when order is irrelevant.

        One event stream at a time per pool; ``items`` may be an infinite
        iterator (ordered consumption gives natural backpressure).
        """
        if self._feeder is not None:
            raise RuntimeError("pool already consumed; create a new one")
        # ordered mode bounds how far the feeder runs ahead of the
        # consumer's cursor, keeping the `pending` re-sequencing buffer
        # to a fixed number of shards even when shard sizes are skewed
        self._window = (2 * self.workers + 2) if ordered else None
        self._feeder = threading.Thread(
            target=self._feed, args=(items,), daemon=True)
        self._feeder.start()

        done_seen = 0
        cur = 0                       # next idx to emit (ordered mode)
        pending: dict[int, list] = {}  # idx -> buffered events (ordered mode)
        received: dict[int, int] = {}  # idx -> results decoded (supervise)
        kills: dict[int, int] = {}     # idx -> workers it killed (supervise)
        terminal: set[int] = set()     # idx done/quarantined (supervise)
        backoff = 0.05

        def finished() -> bool:
            if not self._feed_done.is_set() or self._total is None:
                return False
            return (cur if ordered else done_seen) >= self._total

        while not finished():
            self._deal()
            if self._feed_error is not None:
                raise ParallelWorkerError(
                    -1, f"task iterable raised: {self._feed_error!r}",
                    "") from self._feed_error
            if self._synthetic:
                idx, kind, payload = self._synthetic.popleft()
            else:
                try:
                    # messages are wid-tagged: hand the sender its
                    # result credit back
                    idx, kind, payload, src = self._results.get(timeout=0.1)
                    self._credits[src].release()
                except _queue_mod.Empty:
                    if self.supervise:
                        if self._results.empty():
                            backoff = self._supervise_tick(
                                received, kills, terminal, backoff)
                        continue
                    # a worker killed from outside (OOM, segfault) never
                    # sends its _DONE: waiting on it would hang forever and
                    # balloon the ordered `pending` buffer
                    crashed = [p for p in self._procs
                               if p.exitcode not in (None, 0)]
                    if crashed and self._results.empty():
                        raise ParallelWorkerError(
                            -1, "worker process(es) died with exit code(s) "
                            f"{[p.exitcode for p in crashed]}", "")
                    if (not any(p.is_alive() for p in self._procs)
                            and self._results.empty() and not finished()):
                        raise ParallelWorkerError(
                            -1, "worker processes exited prematurely", "")
                    continue
            if kind == _ERROR:
                raise ParallelWorkerError(idx, payload[0], payload[1])
            if kind == _DONE:
                self._dealt[src].pop(idx, None)
            if self.supervise and idx in terminal:
                # stale duplicate from a requeue race: the shard already
                # completed; drop the message (still release ring slots)
                if kind == _CHUNK_SHM:
                    self._decode_slot(payload)
                continue
            if kind == _CHUNK_SHM:
                # decode at dequeue time (FIFO per worker): the slot is
                # released immediately, so ordered-mode buffering holds
                # decoded results, never live ring views
                payload = self._decode_slot(payload)
                kind = _CHUNK
                self.transport_stats["results"] += len(payload)
            elif kind == _CHUNK_BLOB:
                payload = pickle.loads(payload)
                kind = _CHUNK
                self.transport_stats["queue_chunks"] += 1
                self.transport_stats["results"] += len(payload)
            elif kind == _CHUNK:
                self.transport_stats["queue_chunks"] += 1
                self.transport_stats["results"] += len(payload)
            if self.supervise and kind == _CHUNK:
                received[idx] = received.get(idx, 0) + len(payload)
            if kind in (_DONE, _QUAR):
                done_seen += 1
                if self.supervise:
                    terminal.add(idx)
            if not ordered:
                if kind == _CHUNK:
                    yield ("chunk", idx, payload)
                elif kind == _DONE:
                    yield ("done", idx, payload)
                else:
                    yield ("quarantined", idx, payload)
                continue
            if idx != cur:
                pending.setdefault(idx, []).append((kind, payload))
                continue
            if kind == _CHUNK:
                yield ("chunk", idx, payload)
                continue
            yield (("done" if kind == _DONE else "quarantined"), idx, payload)
            cur += 1
            self._progress = cur
            # flush buffered successors (a worker's messages are FIFO, so
            # a buffered "done" is always last for its idx)
            while True:
                events = pending.pop(cur, None)
                if not events:
                    break
                advanced = False
                for kind2, payload2 in events:
                    if kind2 == _CHUNK:
                        yield ("chunk", cur, payload2)
                    else:
                        yield (("done" if kind2 == _DONE
                                else "quarantined"), cur, payload2)
                        advanced = True
                if not advanced:
                    break
                cur += 1
                self._progress = cur
        if self._feed_error is not None:
            # the items iterable died partway: the stream above was
            # silently truncated, which must not look like success
            raise ParallelWorkerError(
                -1, f"task iterable raised: {self._feed_error!r}",
                "") from self._feed_error

    def iter_results(self, items: Iterable, *,
                     ordered: bool = True) -> Iterator:
        """Flattened result stream (chunk boundaries dissolved)."""
        for event in self.iter_events(items, ordered=ordered):
            if event[0] == "chunk":
                yield from event[2]

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        """Stop feeding, tear down workers, release queue resources."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        try:
            self._stop_ev.set()
        except (OSError, ValueError):  # pragma: no cover - teardown race
            pass
        if self._feeder is not None:
            self._feeder.join(timeout=2.0)
        for sem in self._sems:   # unblock writers stuck on a full ring
            try:
                for _ in range(_SHM_SLOTS):
                    sem.release()
            except (OSError, ValueError):  # pragma: no cover
                pass
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=2.0)
        self._harvest_worker_stats()  # final: before the segment unlinks
        self._absorb_stats()
        try:
            for conn in self._task_conns:
                if conn is not None:
                    conn.close()
            self._results.close()
        except (OSError, ValueError):  # pragma: no cover - teardown race
            pass
        for seg in self._segments:
            try:
                seg.close()
                seg.unlink()
            except (OSError, FileNotFoundError):  # pragma: no cover
                pass
            _reaper.unregister(seg)
        self._segments = []
        self._sems = []
        if self._stats_seg is not None:
            try:
                self._stats_seg.close()
                self._stats_seg.unlink()
            except (OSError, FileNotFoundError):  # pragma: no cover
                pass
            _reaper.unregister(self._stats_seg)
            self._stats_seg = None

    def __enter__(self) -> "ParallelWarcPool":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    def __del__(self) -> None:  # pragma: no cover - GC backstop
        try:
            self.close()
        except Exception:
            pass


# --------------------------------------------------------------------------
# Shard-level worker functions (module-level: picklable under spawn)
# --------------------------------------------------------------------------

def _extract_documents(path: str, *, min_length: int = 64,
                       status_ok_only: bool = True,
                       readahead: bool | None = None,
                       tolerant: bool = False):
    from repro_torch.core.pipeline import iter_documents

    yield from iter_documents(path, min_length=min_length,
                              status_ok_only=status_ok_only,
                              readahead=readahead, tolerant=tolerant)


def _call_one(fn: Callable, item):
    yield fn(item)


# -- Document frame codec (module-level: picklable under spawn) ----------

_DOC_HEADER = struct.Struct("<iqI")  # uri_len (-1: None), offset, text_len


def _encode_document(doc) -> bytes:
    """One Document → one length-prefixable frame (no pickle)."""
    uri = doc.uri.encode("utf-8") if doc.uri is not None else None
    return (_DOC_HEADER.pack(-1 if uri is None else len(uri),
                             doc.record_offset, len(doc.text))
            + (uri or b"") + doc.text)


def _decode_document(view: memoryview):
    """Frame → Document; copies out of the borrowed ring view (the slot
    recycles right after decode)."""
    from repro_torch.core.pipeline import Document

    uri_len, offset, text_len = _DOC_HEADER.unpack_from(view)
    off = _DOC_HEADER.size
    uri = None
    if uri_len >= 0:
        uri = bytes(view[off:off + uri_len]).decode("utf-8")
        off += uri_len
    return Document(uri, bytes(view[off:off + text_len]), offset)


def iter_documents_parallel(paths: Iterable[str], *,
                            workers: int | None = None,
                            ordered: bool = False,
                            min_length: int = 64,
                            status_ok_only: bool = True,
                            chunk_size: int = _DEFAULT_CHUNK_SIZE,
                            mp_context: str | None = None,
                            transport: str | None = None,
                            readahead: bool | None = None,
                            tolerant: bool = False,
                            supervise: bool = False) -> Iterator:
    """Parallel ``iter_documents`` over many WARC shards.

    Parse, HTTP decode and HTML→text extraction run in ``workers``
    processes; under the default transport each extracted
    :class:`~repro_torch.core.pipeline.Document` chunk is written once into
    a shared-memory ring slot as length-prefixed frames and decoded from a
    zero-copy view of it (``transport="pickle"`` sends it through the
    worker's pipe). ``workers=0`` is the serial path (the same documents,
    one process). ``ordered=True`` reproduces the serial document order;
    the default streams documents as shards finish.
    """
    paths = [p for p in paths]
    if workers is not None and workers <= 0:
        from repro_torch.core.pipeline import iter_documents

        for p in paths:
            yield from iter_documents(p, min_length=min_length,
                                      status_ok_only=status_ok_only,
                                      readahead=readahead,
                                      tolerant=tolerant)
        return
    fn = functools.partial(_extract_documents, min_length=min_length,
                           status_ok_only=status_ok_only,
                           readahead=readahead, tolerant=tolerant)
    with ParallelWarcPool(fn, workers=workers, chunk_size=chunk_size,
                          mp_context=mp_context, transport=transport,
                          frame_codec=(_encode_document, _decode_document),
                          supervise=supervise) as pool:
        yield from pool.iter_results(paths, ordered=ordered)


# -- WarcRecord frame codec (module-level: picklable under spawn) --------

_REC_HEADER = struct.Struct("<qHBI")  # stream_offset, type, http flag, hdr_len


def _encode_record(rec) -> bytes:
    """One detached WarcRecord → one length-prefixable frame."""
    hdr = rec._header_block
    return b"".join((_REC_HEADER.pack(rec.stream_offset,
                                      int(rec.record_type),
                                      1 if rec.http_headers is not None else 0,
                                      len(hdr)),
                     hdr, rec.content_view()))


def _decode_record(view: memoryview):
    """Frame → WarcRecord (owning copies; the ring slot recycles).

    HTTP parse state crosses the boundary as one flag: re-running
    ``parse_http_fast`` on the identical content bytes reproduces the
    worker's ``http_headers``/``http_content_offset`` exactly, so the
    shm path returns the same records the pickle path does."""
    from repro_torch.core.warc.http import parse_http_fast
    from repro_torch.core.warc.record import (RECORD_TYPE_FROM_VALUE,
                                              WarcRecord)

    offset, type_value, has_http, hdr_len = _REC_HEADER.unpack_from(view)
    off = _REC_HEADER.size
    rec = WarcRecord(bytes(view[off:off + hdr_len]),
                     RECORD_TYPE_FROM_VALUE[type_value],
                     bytes(view[off + hdr_len:]), offset)
    if has_http:
        http, body_off = parse_http_fast(rec._content)
        rec.http_headers = http
        rec.http_content_offset = body_off if http is not None else -1
    return rec


def _extract_records(path: str, *, types_value: int, parse_http: bool,
                     readahead: bool | None = None,
                     tolerant: bool = False):
    from repro_torch.core.warc import FastWARCIterator

    it = FastWARCIterator(path, parse_http=parse_http, readahead=readahead,
                          tolerant=tolerant)
    try:
        for rec in it:
            if not int(rec.record_type) & types_value:
                continue
            # detach: frames are encoded (and pipe-fallback chunks
            # pickled) after the parse arena has moved on
            yield rec.detach()
    finally:
        # a worker torn down mid-shard (pool close) must join the
        # shard's decoder thread, not leak it
        it.close()


def iter_records_parallel(paths: Iterable[str], *,
                          record_types=None,
                          parse_http: bool = False,
                          workers: int | None = None,
                          ordered: bool = False,
                          chunk_size: int = _DEFAULT_CHUNK_SIZE,
                          mp_context: str | None = None,
                          transport: str | None = None,
                          readahead: bool | None = None,
                          tolerant: bool = False,
                          supervise: bool = False,
                          max_respawns: int = 3,
                          hang_timeout_s: float | None = None) -> Iterator:
    """Parallel bulk record export: full WARC records out of many shards.

    Whole record blocks cross the process boundary — the workload the
    shared-memory transport exists for: each record travels as one
    length-prefixed frame in a ring slot instead of being pickled into a
    pipe. Records arrive detached (owning copies); ``record_types``
    (a :class:`~repro_torch.core.warc.WarcRecordType` flag, default any)
    selects which. ``workers=0`` is the serial fallback (identical
    output, one process). ``supervise=True`` retries worker deaths
    mid-shard, resuming exactly after the records already delivered (see
    :class:`ParallelWarcPool`). ``tolerant=True`` makes each worker's
    parser recover from damaged records (only intact survivors are
    streamed back; the ledger stays in the worker — ``build_index``
    reports the damage).
    """
    from repro_torch.core.warc import WarcRecordType

    paths = [p for p in paths]
    if record_types is None:
        record_types = WarcRecordType.any_type
    if workers is not None and workers <= 0:
        for p in paths:
            yield from _extract_records(p, types_value=int(record_types),
                                        parse_http=parse_http,
                                        readahead=readahead,
                                        tolerant=tolerant)
        return
    fn = functools.partial(_extract_records, types_value=int(record_types),
                           parse_http=parse_http, readahead=readahead,
                           tolerant=tolerant)
    with ParallelWarcPool(fn, workers=workers, chunk_size=chunk_size,
                          mp_context=mp_context, transport=transport,
                          frame_codec=(_encode_record, _decode_record),
                          supervise=supervise, max_respawns=max_respawns,
                          hang_timeout_s=hang_timeout_s) as pool:
        yield from pool.iter_results(paths, ordered=ordered)


def map_shards(fn: Callable, items: Iterable, *,
               workers: int | None = None,
               mp_context: str | None = None,
               supervise: bool = False,
               max_respawns: int = 3,
               hang_timeout_s: float | None = None,
               poison_kills: int = 2,
               with_obs: bool = False,
               cuda_workers: bool = False) -> list:
    """Apply ``fn`` (module-level, one picklable result) per shard.

    Returns results in ``items`` order — the map half of map-reduce
    analytics over shard collections. Each result crosses as one pickled
    message on the worker's result pipe (transport ``"pickle"``: shard
    partials outgrow any ring slot). With ``supervise=True`` worker
    deaths are retried (see :class:`ParallelWarcPool`); a shard
    quarantined as poison yields ``None`` in its slot instead of
    aborting the whole map. ``cuda_workers=True`` says ``fn`` launches
    CUDA kernels, so the workers are never forked.

    With ``with_obs=True`` returns ``(results, snapshot)`` where
    ``snapshot`` is one merged :class:`~repro_torch.obs.ObsSnapshot`
    spanning the whole process tree: the parent registry, the pool's
    transport/supervisor counters, and every worker incarnation's
    published counters — all of which the pool's ``close()`` absorbed
    into the process-default registry, so the snapshot composes with
    later layers without double-counting.
    """
    items = [it for it in items]
    if workers is not None and workers <= 0 or len(items) <= 1:
        out = [fn(it) for it in items]
        # serial path: fn ran in-process, its counters are already in
        # the parent registry
        return (out, obs.snapshot()) if with_obs else out
    out = [None] * len(items)
    # one result a shard, a partial index or a shard's whole payload:
    # far over a ring slot, so no ring segments (transport "pickle")
    with ParallelWarcPool(functools.partial(_call_one, fn), workers=workers,
                          chunk_size=1, mp_context=mp_context,
                          transport="pickle",
                          supervise=supervise, max_respawns=max_respawns,
                          hang_timeout_s=hang_timeout_s,
                          poison_kills=poison_kills,
                          cuda_workers=cuda_workers) as pool:
        for event in pool.iter_events(items, ordered=True):
            if event[0] == "chunk":
                out[event[1]] = event[2][0]
    if with_obs:
        # after close(): the final harvest (post worker join) and the
        # pool's own counters were absorbed into the process registry —
        # one snapshot, nothing counted twice
        return out, obs.snapshot()
    return out
