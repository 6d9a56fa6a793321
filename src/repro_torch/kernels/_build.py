"""Build the package's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``kernels/<name>/csrc/*.cu`` file is compiled into its own shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <stem>-<hash>.so <stem>.cu

All sources build at the first use of any kernel, one ``nvcc`` process
per source, all started together. The libraries land in
``build/repro_torch_kernels/`` at the root of the checkout; a library's
file name carries a hash of its sources and flags, so an edited source
rebuilds and an unchanged one is reused. ``nvcc``'s output (the
``-Xptxas -v`` register and shared-memory report) is kept beside each
library as ``<stem>-<hash>.log``.

Builds are safe across processes (pool workers that start on a cold
``build/`` at once): ``nvcc`` writes a temporary file that is renamed
over the library in one step, and the whole build runs under an
exclusive ``flock`` on ``BUILD_DIR/.lock`` — a process that waited for
the lock finds the libraries built and compiles nothing.

Each C entry point returns ``cudaGetLastError()`` after its launch; the
Python wrappers raise when that is not 0.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_all", "build_log", "library"]

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_built: dict[str, Path] = {}
_loaded: dict[str, ctypes.CDLL] = {}


def _sources() -> dict[str, Path]:
    """``stem -> .cu path`` for every kernel source of the package."""
    out: dict[str, Path] = {}
    for src in sorted(_KERNELS_DIR.glob("*/csrc/*.cu")):
        if src.stem in out:
            raise RuntimeError(f"two kernel sources named {src.stem}.cu")
        out[src.stem] = src
    return out


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(src: Path) -> Path:
    """Library path keyed by the hash of the source, its headers, flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [src, *sorted(src.parent.glob("*.cuh"))]:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _build_lock():
    """Exclusive lock on the build directory, across processes."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all() -> dict[str, Path]:
    """Compile every stale source (one ``nvcc`` each, run concurrently)
    and return ``stem -> library path``. Raises with ``nvcc``'s output
    if any build fails."""
    with _lock:
        if _built:
            return dict(_built)
        targets = {stem: (src, _target(src))
                   for stem, src in _sources().items()}
        if any(not lib.is_file() for _, lib in targets.values()):
            with _build_lock():  # re-check: another process may have built
                _compile({stem: st for stem, st in targets.items()
                          if not st[1].is_file()})
        _built.update({stem: lib for stem, (_, lib) in targets.items()})
        return dict(_built)


def _compile(stale: dict[str, tuple[Path, Path]]) -> None:
    """Run ``nvcc`` on each ``stem -> (source, library)``, all at once."""
    if not stale:
        return
    nvcc = _nvcc()
    procs = {}
    for stem, (src, lib) in stale.items():
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        log = open(lib.with_suffix(".log"), "wb")
        procs[stem] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT), tmp, lib, log)
    failed = []
    for stem, (proc, tmp, lib, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{stem}.cu (exit {rc}):\n"
                          + lib.with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def build_log(stem: str) -> str:
    """``nvcc``'s output of the build of ``<stem>.cu`` (empty when the
    library was reused from an earlier build with no log kept)."""
    log = build_all()[stem].with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``<stem>.cu`` (builds on first use)."""
    lib = _loaded.get(stem)
    if lib is None:
        path = build_all()[stem]
        with _lock:
            lib = _loaded.get(stem)
            if lib is None:
                lib = _loaded[stem] = ctypes.CDLL(str(path))
    return lib
