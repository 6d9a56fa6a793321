"""End-to-end smoke run of ``repro_torch`` on one NVIDIA GPU (H100, sm_90a).

Drives the port's main path — synthetic gzip corpus → ``build_index`` →
``IndexQueryService`` literal and regex searches (CDX+seek scan) — through
its public entry points on the card, and holds every kernel of that path
against its plain PyTorch version:

1. corpus: 4 gzip shards of ``CorpusSpec(n_pages=10_000, seed=i)`` written
   by 4 spawned processes before any CUDA work;
2. device: requires CUDA, prints ``nvidia-smi``'s name and power limit;
3. build: compiles the CUDA sources with ``nvcc`` (``build/``);
4. kernel checks: each kernel bit-identical to its plain version at the
   main path's shapes and edge cases, timed with CUDA events;
5. main path: ``build_index(device="cuda")``; every digest against
   ``zlib.adler32``, a seeded sample of signatures against
   ``signature_of``, and a ``save``/``load`` round trip;
6. serve: ``IndexQueryService(device="cuda")`` over 8 requests, each
   held against the ``full_scan_search`` / ``full_scan_regex`` oracles;
7. launch counts of both kernels on the main path (each must be > 0).

Every phase raises on failure. The script prints a ``{"kernels": ...}``
JSON line, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. It exits non-zero without a result
when CUDA is unavailable or the package is missing.

Usage: ``python3 chip_smoke.py [--pages N] [--json-out PATH]``
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
import zlib
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.core.warc import FastWARCIterator  # noqa: E402
from repro_torch.data.synth import CorpusSpec, records_in, write_corpus  # noqa: E402
from repro_torch.index import (  # noqa: E402
    CdxIndex, HeaderFilter, IndexQueryService, QueryRequest, build_index,
    full_scan_regex, full_scan_search)
from repro_torch.index.signature import signature_of  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.digest_sig import digest_sig as ds  # noqa: E402
from repro_torch.kernels.pattern_scan import pattern_scan as ps  # noqa: E402

N_SHARDS = 4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12    # H100 SXM non-tensor 32-bit rate (data sheet)
SIG_SAMPLE = 2048
SLEEP_CYCLES = 4_000_000    # ~2 ms of device spin ahead of each timed call
CDX_COLUMNS = ("shard_id", "offset", "comp_len", "uncomp_len", "rtype",
               "status", "digest", "signatures", "frame_off", "frame_base",
               "uri_off", "mime_off")
SEED = 0

# the serve phase's requests: (label, request); every literal/regex is
# checked against the full-scan oracles
REQUESTS = [
    ("broad literal", QueryRequest(b"nginx/1.2")),
    ("selective literal", QueryRequest(b"web archive")),
    ("16-byte literal", QueryRequest(b"nginx/1.25\r\nDate")),
    ("literal longer than the kernel window",
     QueryRequest(b"university science compute")),
    ("literal shorter than the n-gram",
     QueryRequest(b"<a", HeaderFilter(url_prefix=b"https://research.edu/ab"))),
    ("regex", QueryRequest(rb"fetchTimeMs: 9[0-9]\r\n", regex=True)),
    ("regex, two literals",
     QueryRequest(rb"<title>[a-z]+ web archive", regex=True)),
    ("literal, status 200",
     QueryRequest(b"web archive", HeaderFilter(status=200))),
]
BROAD_SHARE = 0.10  # the broad literal's candidates, share of responses


def log(msg: str) -> None:
    print(msg, flush=True)


def _write_shard(args: tuple[str, int, int]) -> tuple[str, int]:
    path, pages, seed = args
    return path, write_corpus(path, CorpusSpec(n_pages=pages, seed=seed),
                              "gzip")


# -- phase 1 ---------------------------------------------------------------
def make_corpus(workdir: Path, pages: int) -> list[str]:
    if workdir.exists():
        shutil.rmtree(workdir)
    workdir.mkdir(parents=True)
    t0 = time.perf_counter()
    jobs = [(str(workdir / f"crawl-{i:02d}.warc.gz"), pages, i)
            for i in range(N_SHARDS)]
    # spawned workers: no process forks from one that holds a CUDA context
    with ProcessPoolExecutor(N_SHARDS, mp_context=get_context("spawn")) as ex:
        done = list(ex.map(_write_shard, jobs))
    paths = [p for p, _ in done]
    comp = sum(n for _, n in done)
    records = uncomp = 0
    for p in paths:
        for rec in FastWARCIterator(p, parse_http=False):
            records += 1
            uncomp += rec.content_length
    want = N_SHARDS * records_in(CorpusSpec(n_pages=pages))
    if records != want:
        raise RuntimeError(f"corpus has {records} records, want {want}")
    log(f"[corpus] {N_SHARDS} gzip shards x {pages} pages: {records} records, "
        f"{comp} compressed bytes, {uncomp} record-content bytes, "
        f"{time.perf_counter() - t0:.3f} s")
    return paths


# -- phase 2 ---------------------------------------------------------------
def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# -- timing helpers --------------------------------------------------------
_FLUSH: torch.Tensor | None = None


def time_ms(fn, reps: int = 25) -> float:
    """Median device time of one call (CUDA events), the 50 MB L2 flushed
    before each call so inputs come from device memory as on the main
    path. A device-side sleep queued first lets the host enqueue the
    flush, both events and the call before the device reaches them, so
    the events bracket device execution and not host launch latency."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()  # warm-up
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        _FLUSH.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate or operations
    over the scalar rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_cost(rows: int, width: int, plen: int) -> tuple[int, int]:
    """pattern_scan: read (rows, W+16) + pattern, write (rows, W);
    one compare and one AND per pattern byte per position."""
    return rows * (width + 16) + 16 + rows * width, rows * width * 2 * plen


def digest_cost(rows: int, width: int, kblock: int, n: int) -> tuple[int, int]:
    """digest_sig: read (rows, W+128), write (rows, W) int32 hashes and two
    (rows, W/kblock) int32 partials; per position n-1 multiply-adds for
    the hash and three operations for S and T."""
    nsb = width // kblock
    return (rows * (width + 128) + rows * width * 4 + 2 * rows * nsb * 4,
            rows * width * (2 * (n - 1) + 3))


# -- phase 4 ---------------------------------------------------------------
def scan_inputs(rng, rows: int, width: int) -> tuple[torch.Tensor, np.ndarray]:
    pat = np.frombuffer(b"WARC/1.1\r\nWARC-T", np.uint8)  # 16 bytes
    m = np.zeros((rows, width + 16), np.uint8)
    m[:, :width] = rng.choice(np.frombuffer(b"WARC/1.\r\n-T", np.uint8),
                              size=(rows, width))
    live = max(1, rows - rows // 4)           # trailing rows stay padding
    m[live:] = 0
    for r in range(live):
        for at in (0, 8192 - 7, 16 - 3, width - 16, width - 5):
            if 0 <= at < width:              # straddles chunk / tile edges;
                end = min(at + 16, width)    # the last one runs into the tail
                m[r, at:end] = pat[:end - at]
    if live > 1:
        m[0, :width] = 0xFF                    # all-0xFF row
    return torch.from_numpy(m).cuda(), pat


def digest_inputs(rng, rows: int, width: int) -> torch.Tensor:
    m = np.zeros((rows, width + 128), np.uint8)
    live = max(1, rows - rows // 4)
    for r in range(live):
        n = int(rng.integers(1, width + 1))
        m[r, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    m[0, :width] = 0xFF                        # forces the uint32 hash wrap
    return torch.from_numpy(m).cuda()


def kernel_checks(results: dict) -> None:
    rng = np.random.default_rng(SEED)
    err = {"pattern_scan": 0, "digest_sig": 0}
    for rows in (1, 3, 64):
        for width in (8192, 24576, 65536):
            x, pat = scan_inputs(rng, rows, width)
            ff = np.full(16, 0xFF, np.uint8)
            for plen in (1, 4, 16):
                for p in (pat, ff):
                    got = ps.pattern_scan_batch(x, p, plen)
                    want = ps.pattern_scan_plain(x, p, plen)
                    torch.cuda.synchronize()
                    d = int((got.int() - want.int()).abs().max())
                    err["pattern_scan"] = max(err["pattern_scan"], d)
                    if d or (p is pat and not int(want.sum())):
                        raise RuntimeError(
                            f"pattern_scan B={rows} W={width} P={plen}: "
                            f"max |kernel - plain| = {d}, plain matches "
                            f"{int(want.sum())}")
            ms = time_ms(lambda: ps.pattern_scan_batch(x, pat, 16))
            plain = time_ms(lambda: ps.pattern_scan_plain(x, pat, 16), 20)
            b, _ = bound(*scan_cost(rows, width, 16))
            log(f"[kernels] pattern_scan B={rows} W={width} P=16: "
                f"{ms:.4g} ms/launch, bound {b:.4g} ms, plain {plain:.4g} ms")
    for rows in (1, 6, 512):
        for width in (256, 1536, 2048, 6144, 32768):
            kblock = min(ds.BLOCK, width)
            x = digest_inputs(rng, rows, width)
            got = ds.digest_sig_partials_batch(x, n=4, block=kblock)
            want = ds.digest_sig_plain(x, n=4, block=kblock)
            torch.cuda.synchronize()
            d = max(int((g.long() - w.long()).abs().max())
                    for g, w in zip(got, want))
            err["digest_sig"] = max(err["digest_sig"], d)
            if d:
                raise RuntimeError(f"digest_sig B={rows} W={width}: max "
                                   f"|kernel - plain| = {d}")
            ms = time_ms(lambda: ds.digest_sig_partials_batch(
                x, n=4, block=kblock))
            plain = time_ms(lambda: ds.digest_sig_plain(
                x, n=4, block=kblock), 20)
            b, _ = bound(*digest_cost(rows, width, kblock, 4))
            log(f"[kernels] digest_sig B={rows} W={width}: {ms:.4g} "
                f"ms/launch, bound {b:.4g} ms, plain {plain:.4g} ms")
    results["max_abs_err"] = err
    log(f"[kernels] every kernel output bit-identical to its plain version "
        f"(max |kernel - plain| = {err})")


def dominant_shape(kernel: str) -> tuple[int, int]:
    """(padded rows, width) of the width bucket that moved the most padded
    bytes on the main path (mean padded rows per launch, quantized)."""
    from repro_torch.kernels.bucketing import quantize_count

    c = obs.snapshot().counters
    pre = f"kernel.{kernel}.w"
    best = max((k for k in c if k.startswith(pre)
                and k.endswith(".padded_bytes")), key=c.get)
    width = int(best[len(pre):].split(".")[0])
    launches = c[f"{pre}{width}.dispatches"]
    return quantize_count(round(c[best] / width / launches)), width


# -- phase 5 ---------------------------------------------------------------
def main_build(paths: list[str], workdir: Path, results: dict) -> CdxIndex:
    obs.reset()
    ds.launches = 0
    t0 = time.perf_counter()
    index = build_index(paths, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    results["digest_sig_launches"] = ds.launches
    c = obs.snapshot().counters
    stage = {k: c.get(f"index.stage.{k}_us", 0) / 1e6
             for k in ("parse", "digest_sig", "assemble")}
    split = {k: c.get(f"stage.digest_signature_batch.{k}_us", 0) / 1e6
             for k in ("h2d", "kernel", "d2h", "fold")}
    results["build"] = {"records": len(index), "seconds": dt,
                        "records_per_s": len(index) / dt, "stages_s": stage,
                        "digest_sig_split_s": split}
    log(f"[build] {len(index)} records in {dt:.3f} s = "
        f"{len(index) / dt:.1f} records/s; stages (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
        + "; digest_sig split (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    results["digest_sig_shape"] = dominant_shape("digest_signature_batch")

    # every digest against zlib, a seeded sample of signatures on the host
    n_sample = min(SIG_SAMPLE, len(index))
    sample = set(np.random.default_rng(SEED).choice(
        len(index), n_sample, replace=False).tolist())
    row = 0
    for p in paths:
        for rec in FastWARCIterator(p, parse_http=False):
            content = rec.content
            if int(index.offset[row]) != rec.stream_offset:
                raise RuntimeError(f"row {row}: offset mismatch")
            if int(index.digest[row]) != zlib.adler32(content):
                raise RuntimeError(f"row {row}: digest != zlib.adler32")
            if row in sample and not np.array_equal(
                    index.signatures[row], signature_of(content)):
                raise RuntimeError(f"row {row}: signature != signature_of")
            row += 1
    if row != len(index):
        raise RuntimeError(f"index has {len(index)} rows, corpus {row}")
    cdx = workdir / "corpus.cdx"
    nbytes = index.save(str(cdx))
    back = CdxIndex.load(str(cdx))
    for name in CDX_COLUMNS:
        if not np.array_equal(getattr(back, name), getattr(index, name)):
            raise RuntimeError(f"save/load round trip changed {name}")
    if (back.uri_heap, back.mime_heap) != (index.uri_heap, index.mime_heap):
        raise RuntimeError("save/load round trip changed the heaps")
    log(f"[build] all {row} digests == zlib.adler32; {n_sample} sampled "
        f"signatures == signature_of; save/load round trip equal "
        f"({nbytes} bytes)")
    return index


# -- phase 6 ---------------------------------------------------------------
def serve(index: CdxIndex, paths: list[str], results: dict) -> None:
    reqs = []
    for _, r in REQUESTS:  # every hit comes back: top_k covers the corpus
        r.top_k = len(index)
        reqs.append(r)
    obs.reset()
    ps.launches = 0
    t0 = time.perf_counter()
    with IndexQueryService(index, device="cuda") as svc:
        responses = svc.serve(reqs)
        stats = dict(svc.engine.stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    results["pattern_scan_launches"] = ps.launches
    results["pattern_scan_shape"] = dominant_shape("find_pattern_mask_batch")
    c = obs.snapshot().counters
    split = {k: c.get(f"stage.find_pattern_mask_batch.{k}_us", 0) / 1e6
             for k in ("h2d", "kernel", "d2h")}
    row_of = {(index.shard_paths[int(s)], int(o)): i
              for i, (s, o) in enumerate(zip(index.shard_id, index.offset))}
    served = []
    for (label, req), resp in zip(REQUESTS, responses):
        if req.regex:
            oracle = full_scan_regex(paths, req.pattern)
        else:
            oracle = full_scan_search(paths, req.pattern)
        if req.filters is not None:
            keep = set(np.flatnonzero(
                svc.engine.header_mask(req.filters)).tolist())
            oracle = {k: v for k, v in oracle.items() if row_of[k] in keep}
        got = {(h.shard, h.offset): h.n_matches for h in resp.hits}
        if got != oracle or resp.total_matches != len(oracle):
            raise RuntimeError(f"request {label!r}: {len(got)} hits differ "
                               f"from the {len(oracle)}-record oracle")
        served.append({"label": label, "hits": len(got),
                       "latency_ms": resp.latency_s * 1e3})
        log(f"[serve] {label} {req.pattern!r}: {len(got)} records == "
            f"oracle, {resp.latency_s * 1e3:.3f} ms")
    n_resp = int((index.rtype == 4).sum())
    share = svc.engine.plan(REQUESTS[0][1].pattern).rows.size / n_resp
    if share < BROAD_SHARE:
        raise RuntimeError(f"broad literal selects only {share:.3f} of the "
                           f"response records as candidates")
    results["serve"] = {"requests": served, "seconds": dt, "stats": stats,
                        "scan_split_s": split, "broad_share": share}
    log(f"[serve] {len(reqs)} requests in {dt:.3f} s; broad literal "
        f"candidates = {share:.3f} of the {n_resp} response records; scan "
        f"split (s): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; engine {stats}")


def kernel_line(results: dict) -> dict:
    rng = np.random.default_rng(SEED + 1)
    rows, width = results["pattern_scan_shape"]
    x, pat = scan_inputs(rng, rows, width)
    ms = time_ms(lambda: ps.pattern_scan_batch(x, pat, 16))
    plain = time_ms(lambda: ps.pattern_scan_plain(x, pat, 16), 20)
    b_scan, by_scan = bound(*scan_cost(rows, width, 16))
    drows, dwidth = results["digest_sig_shape"]
    kblock = min(ds.BLOCK, dwidth)
    y = digest_inputs(rng, drows, dwidth)
    dms = time_ms(lambda: ds.digest_sig_partials_batch(y, n=4, block=kblock))
    dplain = time_ms(lambda: ds.digest_sig_plain(y, n=4, block=kblock), 20)
    b_dig, by_dig = bound(*digest_cost(drows, dwidth, kblock, 4))
    return {"kernels": [
        {"name": "pattern_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/pattern_scan/csrc/pattern_scan.cu",
         "replaces": "src/repro/kernels/pattern_scan/pattern_scan.py:122",
         "launches": results["pattern_scan_launches"],
         "max_abs_err": results["max_abs_err"]["pattern_scan"],
         "ms": ms, "plain_ms": plain, "bound_ms": b_scan,
         "bound_by": by_scan, "library_ms": None,
         "shape": [rows, width + 16], "pattern_len": 16},
        {"name": "digest_sig", "route": "cuda",
         "source": "src/repro_torch/kernels/digest_sig/csrc/digest_sig.cu",
         "replaces": "src/repro/kernels/digest_sig/digest_sig.py:84",
         "launches": results["digest_sig_launches"],
         "max_abs_err": results["max_abs_err"]["digest_sig"],
         "ms": dms, "plain_ms": dplain, "bound_ms": b_dig,
         "bound_by": by_dig, "library_ms": None,
         "shape": [drows, dwidth + 128]},
    ]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pages", type=int, default=10_000,
                    help="pages per shard (default 10000)")
    ap.add_argument("--json-out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    workdir = ROOT / "build" / "chip_smoke"
    results: dict = {}
    paths = make_corpus(workdir, args.pages)

    card = device_line()
    results["card"] = card
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    results["build_kernels_s"] = time.perf_counter() - t0
    log(f"[build-kernels] {sorted(libs)} in {results['build_kernels_s']:.3f} "
        f"s into {_build.BUILD_DIR}")
    for stem in sorted(libs):
        for line in _build.build_log(stem).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build-kernels] {stem}: {line.strip()}")

    kernel_checks(results)
    index = main_build(paths, workdir, results)
    serve(index, paths, results)

    log(f"[launches] main path: digest_sig {results['digest_sig_launches']} "
        f"(build), pattern_scan {results['pattern_scan_launches']} (serve)")
    if results["digest_sig_launches"] <= 0 or \
            results["pattern_scan_launches"] <= 0:
        raise RuntimeError("a kernel of the main path was never launched")

    line = kernel_line(results)
    results.update(line)
    results["seconds"] = time.perf_counter() - t_start
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(results, indent=1))
    shutil.rmtree(workdir)
    print(json.dumps(line), flush=True)
    print(device_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
