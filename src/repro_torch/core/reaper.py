"""Orphaned shared-memory reaper: no segment survives its creator.

The shm transport of ``ParallelWarcPool`` (its per-worker rings and its
stats slots) creates ``/dev/shm`` segments that normally die in
``close()``. Two abnormal paths used to leak them:

* the parent is SIGKILLed mid-bench — ``finally`` blocks never run, the
  segment outlives every process that knew its name;
* an exception between segment creation and the owning object's
  construction completing (partially mitigated case-by-case before).

This module closes both holes structurally:

1. every segment is created through :func:`create_segment` under a
   parseable name — ``repro_torch-shm-<pid>-<seq>-<tag>`` — and
   registered for an ``atexit`` unlink (covers normal exits and
   unhandled exceptions);
2. :func:`reap_orphans` scans ``/dev/shm`` for our prefix and unlinks
   any segment whose creator pid is gone (covers SIGKILL: the *next* run
   sweeps the leak). It runs lazily, once per process, the first time a
   segment is created.

The prefix is this package's own: the reference package's reaper sweeps
``repro-shm-*`` and this one ``repro_torch-shm-*``, so neither ever
unlinks a segment the other created.

POSIX semaphores need no reaping: CPython's ``SemLock`` calls
``sem_unlink`` immediately after ``sem_open``, so a killed process can
strand at most the kernel object until its last inheritor dies — nothing
persists on the filesystem across runs.
"""
from __future__ import annotations

import atexit
import itertools
import os
import secrets
import threading

try:
    from multiprocessing import shared_memory as _shm_mod
except ImportError:  # pragma: no cover - py>=3.8 everywhere we run
    _shm_mod = None

__all__ = ["SHM_PREFIX", "create_segment", "unregister", "reap_orphans"]

SHM_PREFIX = "repro_torch-shm"
_SHM_DIR = "/dev/shm"

_lock = threading.Lock()
_seq = itertools.count()
_live: dict[str, object] = {}  # name -> SharedMemory (this process's own)
_atexit_armed = False
_swept_pid: int | None = None  # pid that last ran the orphan sweep


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # pragma: no cover - exists, not ours
        return True
    return True


def _cleanup_at_exit() -> None:
    pid = str(os.getpid())
    with _lock:
        doomed = list(_live.values())
        _live.clear()
    for shm in doomed:
        if shm.name[len(SHM_PREFIX) + 1:].split("-")[0] != pid:
            # forked child inherited the parent's registry + atexit hook:
            # the parent's live segments are not ours to unlink
            continue
        try:
            shm.close()
            shm.unlink()
        except (OSError, FileNotFoundError):  # already gone / teardown race
            pass


def reap_orphans() -> list[str]:
    """Unlink prefix-matching segments whose creator process is dead.

    Returns the names reaped (for tests/telemetry). Safe to call any
    time; never touches segments of live processes (including ours).
    """
    reaped: list[str] = []
    try:
        names = os.listdir(_SHM_DIR)
    except OSError:  # pragma: no cover - non-Linux or exotic mount
        return reaped
    for name in names:
        if not name.startswith(SHM_PREFIX + "-"):
            continue
        try:
            pid = int(name[len(SHM_PREFIX) + 1:].split("-")[0])
        except (IndexError, ValueError):
            continue
        if pid == os.getpid() or _pid_alive(pid):
            continue
        try:
            os.unlink(os.path.join(_SHM_DIR, name))
            reaped.append(name)
        except OSError:  # pragma: no cover - lost a race with another reaper
            pass
    return reaped


def create_segment(size: int):
    """Create a registered, reapable ``SharedMemory`` segment."""
    global _atexit_armed, _swept_pid
    if _shm_mod is None:  # pragma: no cover - py>=3.8 everywhere
        raise RuntimeError("shared_memory unavailable")
    pid = os.getpid()
    with _lock:
        if not _atexit_armed or _swept_pid != pid:
            # first segment of this process: arm the exit hook and sweep
            # leftovers of dead predecessors (both re-armed after fork —
            # the child has its own pid, registry entries stay parent's)
            atexit.register(_cleanup_at_exit)
            _atexit_armed = True
            _swept_pid = pid
            _live.clear()  # forked copy of the parent's registry: not ours
    reap_orphans()
    name = f"{SHM_PREFIX}-{pid}-{next(_seq)}-{secrets.token_hex(4)}"
    # keep the segment out of multiprocessing's resource tracker — a
    # helper process that unlinks whatever its creator registered the
    # instant the creator dies. That defeats this module's ownership
    # model twice over: a SIGKILLed creator must leave the segment for
    # the next run's sweep (the contract reap_orphans tests), and a
    # live parent must not lose a pool ring because one forked worker
    # exited and a shared tracker "cleaned up". Lifetime here belongs
    # to atexit + reap_orphans exclusively, so registration is stubbed
    # out around creation (the attach path in parallel.py does the
    # same) and unlink() is wrapped to skip the tracker's unregister —
    # which would otherwise traceback in the tracker process over the
    # registration that never happened.
    from multiprocessing import resource_tracker

    orig_register = resource_tracker.register
    resource_tracker.register = lambda *a, **k: None
    try:
        shm = _shm_mod.SharedMemory(name=name, create=True, size=size)
    finally:
        resource_tracker.register = orig_register
    raw_unlink = shm.unlink

    def _unlink_untracked() -> None:
        orig_unregister = resource_tracker.unregister
        resource_tracker.unregister = lambda *a, **k: None
        try:
            raw_unlink()
        finally:
            resource_tracker.unregister = orig_unregister

    shm.unlink = _unlink_untracked
    with _lock:
        _live[shm.name] = shm
    return shm


def unregister(shm) -> None:
    """Drop a segment from the atexit registry (owner closed it cleanly)."""
    with _lock:
        _live.pop(getattr(shm, "name", shm), None)
