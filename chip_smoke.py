"""End-to-end smoke run of ``repro_torch`` on one NVIDIA GPU (H100, sm_90a).

Drives the port's paths through their public entry points on the card —
synthetic gzip corpus → ``build_index`` → ``IndexQueryService`` literal
and regex searches over CDX+seek; the same corpus → ``columnar.derive``
→ ``QueryEngine.from_store`` → the same searches over the ``.repcol``
row-groups; ``verify_index`` over the whole index; the sharded
``ArchiveGateway`` serving the searches to concurrent clients; the
``fastwarc_lm`` byte-level LM at full width prefilling and serving prompts
taken from the corpus — and holds every kernel of those paths against its
plain PyTorch version:

1. corpus: 4 gzip shards of ``CorpusSpec(n_pages=10_000, seed=i)`` written
   by 4 spawned processes before any CUDA work;
2. device: requires CUDA, prints ``nvidia-smi``'s name and power limit;
3. build: compiles the CUDA sources with ``nvcc`` (``build/``);
4. kernel checks: each kernel bit-identical to its plain version at the
   main path's shapes and edge cases, timed with CUDA events
   (``pattern_scan_batch``, ``digest_sig_partials_batch``,
   ``pattern_scan_rowgroup``, ``digest_signature_rowgroup``'s sub-2048
   widths, ``pattern_scan_batch_multi`` and
   ``pattern_scan_rowgroup_multi`` with mixed pattern lengths and inert
   pad rows, ``adler32_partials_batch`` with all-0xFF and empty rows);
5. main path: ``build_index(device="cuda")``; every digest against
   ``zlib.adler32``, a seeded sample of signatures against
   ``signature_of``, and a ``save``/``load`` round trip;
6. serve: ``IndexQueryService(device="cuda")`` over 8 requests, each
   held against the ``full_scan_search`` / ``full_scan_regex`` oracles;
7. derive: ``derive(device="cuda")`` of the same corpus into a ``.repcol``
   store; its columns bit-equal to phase 5's index, a seeded sample of
   payloads and every timestamp equal to the source records, and the
   row-group kernel checked on the store's widest row-group;
8. columnar serve: ``IndexQueryService(engine=QueryEngine.from_store(
   store, device="cuda"))`` over phase 6's requests plus a ``time_range``
   request, every hit list equal to the oracle and to phase 6's hits;
9. verify: ``verify_index(device="cuda")`` over every record (all True),
   over a copy with three seeded digests flipped (exactly those False),
   and with ``check_signatures=True`` over a copy with one signature bit
   flipped (exactly that row False); ``verify_digests_bulk`` over mixed
   sha1/md5/crc32/adler32/malformed headers equal to ``verify_digest``
   item by item;
10. gateway: ``ArchiveGateway(index, shards=4, device="cuda")`` serving
    8 client threads, each submitting phase 6's requests 4 times in a
    seeded order; every hit list equal to phase 6's; then
    ``find_pattern_masks_multi_rowgroup`` on the store's fullest
    row-group of phase 8's dominant width with phase 8's patterns, equal
    to ``find_pattern_mask_rowgroup`` once per pattern;
11. LM serve: ``fastwarc_lm`` at full width (12 layers, d_model 768, 12
    query heads over 4 KV heads, 76 M float32 parameters from a seeded
    ``torch.Generator``), TF32 off: (a) ``forward`` over the ``serve_1k``
    batch (8 x 1,024 tokens: BOS + the first 1,023 bytes of 8 seeded
    response payloads of phase 1's corpus), warm-up + 5 timed runs, row
    0's logits equal to the CPU forward's; (b) ``ServeEngine(batch_size=8,
    max_seq=1024, temperature=0)`` serving 16 requests of 64-256 payload
    bytes, ``max_new_tokens=64``, each first token equal to the argmax of
    ``forward``'s last-position logits on the card, continued greedily
    over the tokens the engine generates unrecorded while it prefills
    the batch's longer prompts.

Phase 4 also holds ``flash_attention_bhsd`` against its plain version at
the prefill shape (f32), decode ``Sq = 1`` over cache views of 1 and
1,000 keys, InternLM2-1.8B's attention in bf16, a non-causal shape,
``Sq = 256, Sk = 128`` causal (rows with no key exactly 0) and
``Sq = Sk = 37``, and times each against ``scaled_dot_product_attention``.

The launch count of each kernel is set to 0 before each path (phases 5,
6, 7, 8, 9, 10, 11) and read after it; every kernel of a path must have
launched.

Every phase raises on failure. The script prints a ``{"kernels": ...}``
JSON line, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. It exits non-zero without a result
when CUDA is unavailable or the package is missing.

Usage: ``python3 chip_smoke.py [--pages N] [--json-out PATH]``
"""
from __future__ import annotations

import argparse
import cProfile
import importlib
import json
import pstats
import shutil
import subprocess
import sys
import threading
import time
import zlib
from concurrent.futures import ProcessPoolExecutor
from datetime import datetime
from multiprocessing import get_context
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.columnar import ColumnStore, derive  # noqa: E402
from repro_torch.core.warc import FastWARCIterator  # noqa: E402
from repro_torch.data.synth import CorpusSpec, records_in, write_corpus  # noqa: E402
from repro_torch.index import (  # noqa: E402
    CdxIndex, HeaderFilter, IndexQueryService, QueryEngine, QueryRequest,
    RandomAccessReader, build_index, full_scan_regex, full_scan_search)
from repro_torch.core.warc.checksum import (  # noqa: E402
    block_digest, verify_digest, verify_digests_bulk)
from repro_torch.index import verify_index  # noqa: E402
from repro_torch.index.signature import signature_of  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.adler32 import adler32_batch  # noqa: E402
from repro_torch.kernels.digest_sig import digest_sig as ds  # noqa: E402
from repro_torch.kernels.digest_sig import digest_signature_rowgroup  # noqa: E402
from repro_torch.kernels.pattern_scan import pattern_scan as ps  # noqa: E402
from repro_torch.kernels.pattern_scan import (  # noqa: E402
    find_pattern_mask_rowgroup, find_pattern_masks_multi,
    find_pattern_masks_multi_rowgroup)
from repro_torch.obs import trace  # noqa: E402
from repro_torch.obs.export import render_stage_table  # noqa: E402
from repro_torch.serve import ArchiveGateway, Request, ServeEngine  # noqa: E402
from repro_torch.configs import get_spec  # noqa: E402
from repro_torch.core.warc import WarcRecordType  # noqa: E402
from repro_torch.data.tokenizer import BOS_ID, encode  # noqa: E402
from repro_torch.kernels.flash_attention import attention_plain  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

# the kernel modules (the packages' ``adler32`` and ``flash_attention``
# names are the checksum function and the attention wrapper)
ad = importlib.import_module("repro_torch.kernels.adler32.adler32")
fa = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")
N_SHARDS = 4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12    # H100 SXM non-tensor 32-bit rate (data sheet)
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate (data sheet)
LM_REQUESTS = 16            # phase 11's engine requests ...
LM_NEW_TOKENS = 64          # ... each generating at most this many tokens
LM_PREFILL_RUNS = 5         # timed prefill forwards after one warm-up
SIG_SAMPLE = 2048
PAYLOAD_SAMPLE = 4096       # store payloads held against the source records
DIGEST_SAMPLE = 2048        # records whose mixed digest headers phase 9 checks
GW_SHARDS = 4               # gateway scheduler shards (phase 10)
GW_CLIENTS = 8              # client threads, each submitting ...
GW_REPEATS = 4              # ... phase 6's requests this many times
PAD = 128                   # row-group zero tail (ROWGROUP_PAD)
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
STORE_COLUMNS = (("digest", "digest"), ("signatures", "signatures"),
                 ("offset", "offset"), ("rtype", "rtype"),
                 ("status", "status"), ("length", "uncomp_len"),
                 ("shard_id", "shard_id"), ("uri_off", "uri_off"),
                 ("mime_off", "mime_off"))


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


def rowgroup_cost(rows: int, width: int, plen: int) -> tuple[int, int]:
    """pattern_scan_rowgroup: read (rows, W+128) + pattern, write (rows, W);
    one compare and one AND per pattern byte per position."""
    return rows * (width + PAD) + 16 + rows * width, rows * width * 2 * plen


def multi_cost(rows: int, width: int, tail: int,
               lens: np.ndarray) -> tuple[int, int]:
    """pattern_scan_{batch,rowgroup}_multi: read (rows, W+tail), the
    (rows, 16) patterns and (rows,) int32 lengths, write (rows, W); one
    compare and one AND per position per byte of each row's own pattern."""
    return (rows * (width + tail) + rows * width + 17 * rows,
            2 * width * int(np.asarray(lens, np.int64).sum()))


def adler_cost(rows: int, width: int) -> tuple[int, int]:
    """adler32_partials_batch: read (rows, W), write two (rows, W/2048)
    int32 partials; per byte one add for S and one multiply-add for T."""
    return rows * width + 8 * rows * (width // ad.BLOCK), rows * width * 3


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


def rowgroup_inputs(rng, rows: int, width: int, live: int
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A (rows, W + 128) row-group with ``live`` payload rows of random
    length over a small alphabet. Every row starts with the pattern and
    ends, by row, with its 16-, 4- or 1-byte prefix (each at the last
    valid position for that length) or its 9-byte prefix (straddling the
    row's end for longer patterns); row 0 all 0xFF when ``live`` > 1.
    Rows past ``live`` stay zero padding."""
    pat = np.frombuffer(b"WARC/1.1\r\nWARC-T", np.uint8)
    alphabet = np.frombuffer(b"WARC/1.\r\n-T", np.uint8)
    m = np.zeros((rows, width + PAD), np.uint8)
    lengths = rng.integers(16, width + 1, live)
    lengths[-1] = width
    for r, n in enumerate(lengths):
        m[r, :n] = rng.choice(alphabet, n)
        m[r, :16] = pat
        k = (16, 4, 1, 9)[r % 4]
        m[r, n - k:n] = pat[:k]
    if live > 1:
        m[0, :lengths[0]] = 0xFF
    return m, lengths.astype(np.int64), pat


def rowgroup_checks(results: dict) -> None:
    """pattern_scan_rowgroup and the row-group wrappers on the card
    against their plain versions (the CPU path runs the plain version)."""
    rng = np.random.default_rng(SEED + 2)
    ff = np.full(16, 0xFF, np.uint8)
    err = 0
    for width in (256, 1536, 2048, 8192):
        for rows, live in ((1, 1), (3, 2), (1024, 1000)):
            m, lengths, pat = rowgroup_inputs(rng, rows, width, live)
            x = torch.from_numpy(m).cuda()
            for plen in (1, 4, 16):
                for p in (pat, ff):
                    got = ps.pattern_scan_rowgroup(x, p, plen)
                    want = ps.pattern_scan_rowgroup_plain(x, p, plen)
                    torch.cuda.synchronize()
                    d = int((got.int() - want.int()).abs().max())
                    err = max(err, d)
                    if d or (p is pat and not int(want.sum())):
                        raise RuntimeError(
                            f"pattern_scan_rowgroup B={rows} W={width} "
                            f"P={plen}: max |kernel - plain| = {d}, plain "
                            f"matches {int(want.sum())}")
                for trim in (True, False):
                    a = find_pattern_mask_rowgroup(
                        m, lengths, pat[:plen].tobytes(), trim=trim,
                        device="cuda")
                    b = find_pattern_mask_rowgroup(
                        m, lengths, pat[:plen].tobytes(), trim=trim,
                        device="cpu")
                    if a.shape != (live, width) or not np.array_equal(a, b):
                        raise RuntimeError(
                            f"find_pattern_mask_rowgroup B={rows} "
                            f"live={live} W={width} P={plen} trim={trim}: "
                            f"card != plain")
            if rows == 1024:
                ms = time_ms(lambda: ps.pattern_scan_rowgroup(x, pat, 16))
                plain = time_ms(
                    lambda: ps.pattern_scan_rowgroup_plain(x, pat, 16), 20)
                b, _ = bound(*rowgroup_cost(rows, width, 16))
                log(f"[kernels] pattern_scan_rowgroup B={rows} W={width} "
                    f"P=16: {ms:.4g} ms/launch, bound {b:.4g} ms, plain "
                    f"{plain:.4g} ms")
    for width in (256, 1536):  # sub-2048 widths: block = width
        for rows, live in ((6, 5), (1024, 1000)):
            m = np.zeros((rows, width + PAD), np.uint8)
            lengths = rng.integers(0, width + 1, live)
            lengths[:3] = (width, 0, width - 1)
            for r, n in enumerate(lengths):
                m[r, :n] = rng.integers(0, 256, n, dtype=np.uint8)
            m[2, :width - 1] = 0xFF           # forces the uint32 hash wrap
            for a, b in zip(
                    digest_signature_rowgroup(m, lengths, block=width,
                                              device="cuda"),
                    digest_signature_rowgroup(m, lengths, block=width,
                                              device="cpu")):
                if not np.array_equal(a, b):
                    raise RuntimeError(
                        f"digest_signature_rowgroup B={rows} W={width}: "
                        f"card != plain")
    results["max_abs_err"]["pattern_scan_rowgroup"] = err
    log(f"[kernels] pattern_scan_rowgroup and the row-group wrappers "
        f"bit-identical to their plain versions (max |kernel - plain| = "
        f"{err}); digest_signature_rowgroup card == plain at W=256, 1536")


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


MULTI_PATTERNS = [b"W", b"WA", b"ARC", b"WARC", b"WARC/", b"WARC/1", b"WARC/1.",
                  b"WARC/1.1", b"WARC/1.1\r", b"WARC/1.1\r\n",
                  b"WARC/1.1\r\nW", b"WARC/1.1\r\nWA", b"WARC/1.1\r\nWAR",
                  b"WARC/1.1\r\nWARC", b"WARC/1.1\r\nWARC-",
                  b"WARC/1.1\r\nWARC-T"]  # lengths 1..16


def multi_inputs(rng, rows: int, width: int, tail: int, live: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """A (rows, W + tail) matrix whose first ``live`` rows each carry one
    of the 16 patterns (lengths 1..16, cycling), planted at the start,
    across a 16-byte chunk edge, at the last valid position and running
    into the zero tail; row 0 all 0xFF when ``live`` > 1. Rows past
    ``live`` are inert pad rows: all zero, pattern [1, 0, ...] of length
    1. Returns the matrix, patterns and lengths on the card, and the
    longest length."""
    m = np.zeros((rows, width + tail), np.uint8)
    m[:live, :width] = rng.choice(np.frombuffer(b"WARC/1.\r\n-T", np.uint8),
                                  size=(live, width))
    pats = np.zeros((rows, 16), np.uint8)
    pats[live:, 0] = 1
    lens = np.ones(rows, np.int32)
    for r in range(live):
        p = np.frombuffer(MULTI_PATTERNS[r % 16], np.uint8)
        pats[r, :p.size] = p
        lens[r] = p.size
        for at in (0, 16 - 3, width - p.size, width - 5):
            if 0 <= at < width:
                end = min(at + p.size, width)
                m[r, at:end] = p[:end - at]
    if live > 1:
        m[0, :width] = 0xFF
    return (torch.from_numpy(m).cuda(), torch.from_numpy(pats).cuda(),
            torch.from_numpy(lens).cuda(), int(lens.max()))


def multi_checks(results: dict) -> None:
    """pattern_scan_batch_multi and pattern_scan_rowgroup_multi on the card
    against their plain versions: mixed pattern lengths 1..16 in one
    launch, inert pad rows, an all-0xFF row, matches into the zero tail."""
    rng = np.random.default_rng(SEED + 3)
    err = {"pattern_scan_batch_multi": 0, "pattern_scan_rowgroup_multi": 0}
    cases = (("pattern_scan_batch_multi", ps.pattern_scan_batch_multi,
              ps.pattern_scan_multi_plain, 16,
              ((1, 1, 8192), (3, 2, 8192), (48, 40, 8192), (12, 9, 24576),
               (6, 5, 65536))),
             ("pattern_scan_rowgroup_multi", ps.pattern_scan_rowgroup_multi,
              ps.pattern_scan_rowgroup_multi_plain, PAD,
              ((1, 1, 256), (3, 2, 1536), (1024, 1000, 2048),
               (675, 675, 12288))))
    for name, kernel, plain, tail, shapes in cases:
        for rows, live, width in shapes:
            x, p, n, max_len = multi_inputs(rng, rows, width, tail, live)
            got = kernel(x, p, n, max_len)
            want = plain(x, p, n, max_len)
            torch.cuda.synchronize()
            d = int((got.int() - want.int()).abs().max())
            err[name] = max(err[name], d)
            if d or not int(want[:live].sum()) or int(want[live:].sum()):
                raise RuntimeError(
                    f"{name} B={rows} live={live} W={width}: max |kernel - "
                    f"plain| = {d}, plain matches {int(want.sum())}")
        ms = time_ms(lambda: kernel(x, p, n, max_len))
        pms = time_ms(lambda: plain(x, p, n, max_len), 20)
        b, _ = bound(*multi_cost(rows, width, tail, n.cpu().numpy()))
        log(f"[kernels] {name} B={rows} W={width} P=1..16: {ms:.4g} "
            f"ms/launch, bound {b:.4g} ms, plain {pms:.4g} ms")
    results["max_abs_err"].update(err)
    log(f"[kernels] per-row-pattern scans bit-identical to their plain "
        f"versions (max |kernel - plain| = {err})")


def adler_inputs(rng, rows: int, width: int) -> torch.Tensor:
    """(rows, W) payload rows of random length, zero-padded; row 0 all
    0xFF (the largest T of every block), the last row empty."""
    m = np.zeros((rows, width), np.uint8)
    for r in range(rows - 1):
        n = int(rng.integers(1, width + 1))
        m[r, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    m[0] = 0xFF
    if rows > 1:
        m[-1] = 0
    return torch.from_numpy(m).cuda()


def adler_checks(results: dict) -> None:
    """adler32_partials_batch on the card against its plain version, and
    adler32_batch against zlib, at W = 2048 up to 1 MiB."""
    rng = np.random.default_rng(SEED + 4)
    err = 0
    for rows, width in ((1, 2048), (6, 2048), (512, 8192), (64, 65536),
                        (3, 1 << 20)):
        x = adler_inputs(rng, rows, width)
        got = ad.adler32_partials_batch(x)
        want = ad.adler32_plain(x)
        torch.cuda.synchronize()
        d = max(int((g.long() - w.long()).abs().max())
                for g, w in zip(got, want))
        err = max(err, d)
        if d:
            raise RuntimeError(f"adler32 B={rows} W={width}: max |kernel - "
                               f"plain| = {d}")
    ms = time_ms(lambda: ad.adler32_partials_batch(x))
    pms = time_ms(lambda: ad.adler32_plain(x), 20)
    b, _ = bound(*adler_cost(rows, width))
    log(f"[kernels] adler32 B={rows} W={width}: {ms:.4g} ms/launch, bound "
        f"{b:.4g} ms, plain {pms:.4g} ms")
    bufs = [b"", b"\xff" * 2048, b"\xff" * 5000, b"a"] + [
        rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
        for n in rng.integers(0, 40_000, 200)]
    got = adler32_batch(bufs, device="cuda")
    if [int(g) for g in got] != [zlib.adler32(b) for b in bufs]:
        raise RuntimeError("adler32_batch on the card != zlib.adler32")
    results["max_abs_err"]["adler32"] = err
    log(f"[kernels] adler32 bit-identical to its plain version (max "
        f"|kernel - plain| = {err}); adler32_batch == zlib.adler32 on "
        f"{len(bufs)} payloads incl. empty and all-0xFF")


def flash_cost(b: int, h: int, hkv: int, sq: int, sk: int, d: int,
               esize: int, causal: bool) -> tuple[int, int]:
    """flash_attention: read q and k/v once, write the output; 2 flops
    per multiply-add of Q K^T and of P V over the (query, key) pairs the
    mask keeps (causal: key j <= i + Sk - Sq)."""
    i = np.arange(sq, dtype=np.int64)
    pairs = (int(np.clip(i + sk - sq + 1, 0, sk).sum()) if causal
             else sq * sk)
    return (esize * (2 * b * h * sq * d + 2 * b * hkv * sk * d),
            4 * b * h * d * pairs)


def flash_bound(nbytes: int, ops: int, dtype: torch.dtype
                ) -> tuple[float, str]:
    """Least time: bytes over the memory rate, or the flops over the
    card's peak rate for the input type (fp32 CUDA cores, bf16 tensor
    cores), whichever is larger."""
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else SCALAR_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# label, B, H, Hkv, Sq, Sk, D, dtype, causal; "decode" cases read k/v as
# views of a [B, Hkv, 1024, D] cache, as decode_step does
FLASH_CASES = (
    ("prefill", 8, 12, 4, 1024, 1024, 64, torch.float32, True),
    ("decode Sk=1", 8, 12, 4, 1, 1, 64, torch.float32, True),
    ("decode Sk=1000", 8, 12, 4, 1, 1000, 64, torch.float32, True),
    ("internlm2-1.8b bf16", 1, 16, 8, 2048, 2048, 128, torch.bfloat16, True),
    ("non-causal", 2, 12, 4, 512, 700, 64, torch.float32, False),
    ("fully masked rows", 1, 4, 2, 256, 128, 64, torch.float32, True),
    ("ragged 37", 2, 12, 4, 37, 37, 64, torch.float32, True),
)


def flash_checks(results: dict) -> None:
    """flash_attention_bhsd on the card against its plain version (rtol
    1e-4 / atol 1e-5 in f32, 2e-2 in bf16: the reference's kernel-test
    tolerances) at each case, timed beside the plain version and
    ``scaled_dot_product_attention`` (SDPA's causal mask is top-left
    aligned, so a causal case with Sq != Sk has no library time; decode
    is SDPA non-causal over the valid prefix, the same function)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    err = {"float32": 0.0, "bfloat16": 0.0}
    out = {}
    for label, b, h, hkv, sq, sk, d, dt, causal in FLASH_CASES:
        q = torch.randn((b, h, sq, d), generator=gen, device="cuda").to(dt)
        if label.startswith("decode"):
            cache = torch.randn((2, b, hkv, 1024, d), generator=gen,
                                device="cuda").to(dt)
            k, v = cache[0, :, :, :sk], cache[1, :, :, :sk]
        else:
            k, v = (torch.randn((b, hkv, sk, d), generator=gen,
                                device="cuda").to(dt) for _ in range(2))
        got = fa.flash_attention_bhsd(q, k, v, causal=causal)
        want = attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        tol = 2e-2 if dt == torch.bfloat16 else 1e-4
        e = float((got.float() - want.float()).abs().max())
        err[str(dt).split(".")[1]] = max(err[str(dt).split(".")[1]], e)
        try:
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol if dt == torch.bfloat16
                                       else 1e-5)
        except AssertionError as exc:
            raise RuntimeError(f"flash_attention {label}: card != plain: "
                               f"{exc}") from None
        if label == "fully masked rows" and (
                got[:, :, :sq - sk].abs().max() != 0
                or got[:, :, sq - sk:].abs().min() == 0):
            raise RuntimeError("flash_attention: rows with no key != 0")
        ms = time_ms(lambda: fa.flash_attention_bhsd(q, k, v, causal=causal))
        pms = time_ms(lambda: attention_plain(q, k, v, causal=causal), 20)
        lib = lib_err = None
        if not causal or sq == sk or sq == 1:
            def sdpa():
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal and sq == sk and sq > 1,
                    enable_gqa=True)
            lib = time_ms(sdpa)
            lib_err = float((sdpa().float() - want.float()).abs().max())
        nbytes, ops = flash_cost(b, h, hkv, sq, sk, d, q.element_size(),
                                 causal)
        bnd, by = flash_bound(nbytes, ops, dt)
        out[label] = {"shape_q": [b, h, sq, d], "shape_kv": [b, hkv, sk, d],
                      "dtype": str(dt), "causal": causal, "max_abs_err": e,
                      "ms": ms, "plain_ms": pms, "library_ms": lib,
                      "library_max_abs_err": lib_err, "bound_ms": bnd,
                      "bound_by": by, "bytes": nbytes, "flops": ops}
        log(f"[kernels] flash_attention {label} q{[b, h, sq, d]} "
            f"kv{[b, hkv, sk, d]} {str(dt)[6:]} causal={causal}: {ms:.4g} "
            f"ms/launch, bound {bnd:.4g} ms ({by}), plain {pms:.4g} ms, "
            f"SDPA {'%.4g ms' % lib if lib is not None else 'n/a'}; max "
            f"|kernel - plain| = {e:.3g}"
            + (f", |SDPA - plain| = {lib_err:.3g}" if lib_err is not None
               else ""))
    results["flash"] = out
    results["max_abs_err"]["flash_attention"] = err["float32"]
    results["max_abs_err"]["flash_attention_bf16"] = err["bfloat16"]
    log(f"[kernels] flash_attention within tolerance of its plain version "
        f"in every case (max |kernel - plain|: f32 {err['float32']:.3g}, "
        f"bf16 {err['bfloat16']:.3g})")


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


def hit_keys(hits) -> list:
    return [(h.index_row, h.shard, h.offset, h.uri, h.n_matches,
             h.positions.tolist(), h.excerpt) for h in hits]


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
def serve(index: CdxIndex, paths: list[str], results: dict) -> dict:
    """Phase 6; returns ``label -> (oracle, hit keys)`` per request."""
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
    checked = {}
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
        checked[label] = (oracle, hit_keys(resp.hits))
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
    return checked


# -- phase 7 ---------------------------------------------------------------
def warc_date(raw: bytes | None) -> int:
    """WARC-Date → epoch seconds, 0 when absent (independent of derive's
    parser)."""
    if not raw:
        return 0
    return int(datetime.fromisoformat(raw.decode("ascii").strip())
               .timestamp())


def derive_phase(paths: list[str], workdir: Path, index: CdxIndex,
                 results: dict) -> tuple[ColumnStore, np.ndarray]:
    """Phase 7; returns the store and each record's WARC-Date as read from
    the source records."""
    out = workdir / "corpus.repcol"
    obs.reset()
    ds.launches = 0
    t0 = time.perf_counter()
    store = derive(paths, str(out), device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    results["derive_digest_sig_launches"] = ds.launches
    c = obs.snapshot().counters
    stage = {k: c.get(f"derive.stage.{k}_us", 0) / 1e6
             for k in ("parse", "digest_sig", "pack_write")}
    split = {k: c.get(f"stage.digest_signature_rowgroup.{k}_us", 0) / 1e6
             for k in ("h2d", "kernel", "d2h", "fold")}
    waste = store.pad_waste_ratio()
    size = out.stat().st_size
    results["derive"] = {
        "records": len(store), "seconds": dt,
        "records_per_s": len(store) / dt, "stages_s": stage,
        "digest_sig_split_s": split, "rowgroups": store.n_rowgroups,
        "widths": sorted({int(w) for w in store.rg_width}),
        "pad_waste_ratio": waste, "file_bytes": size,
        "digest_sig_launches": ds.launches}
    log(f"[derive] {len(store)} records in {dt:.3f} s = "
        f"{len(store) / dt:.1f} records/s; {store.n_rowgroups} row-groups, "
        f"pad waste {waste:.4f}, {size} bytes; {ds.launches} digest_sig "
        f"launches; stages (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
        + "; digest_sig split (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))

    if len(store) != len(index) or store.shard_paths != index.shard_paths:
        raise RuntimeError("store and index cover different records")
    for col, idx_col in STORE_COLUMNS:
        if not np.array_equal(getattr(store, col), getattr(index, idx_col)):
            raise RuntimeError(f"store column {col} != index {idx_col}")
    if (store.uri_heap, store.mime_heap) != (index.uri_heap,
                                             index.mime_heap):
        raise RuntimeError("store heaps != index heaps")
    n_sample = min(PAYLOAD_SAMPLE, len(store))
    sample = set(np.random.default_rng(SEED).choice(
        len(store), n_sample, replace=False).tolist())
    stamps = np.zeros(len(store), np.int64)
    row = 0
    for p in paths:
        for rec in FastWARCIterator(p, parse_http=False):
            stamps[row] = warc_date(rec.header_bytes(b"WARC-Date:"))
            if row in sample and store.payload(row) != rec.content:
                raise RuntimeError(f"row {row}: store payload != record")
            row += 1
    if not np.array_equal(store.timestamp.astype(np.int64), stamps):
        raise RuntimeError("store timestamps != the records' WARC-Date")
    log(f"[derive] columns and heaps == phase 5's index; {n_sample} "
        f"sampled payloads == record content; every timestamp == WARC-Date")

    # the row-group kernel on the store's widest row-group, real bytes
    g = max(range(store.n_rowgroups),
            key=lambda i: (int(store.rg_width[i]), int(store.rg_rows[i])))
    matrix, _, lens = store.rowgroup(g)
    x = torch.from_numpy(np.array(matrix)).cuda()
    del matrix
    pat = np.frombuffer(b"nginx/1.25\r\nDate", np.uint8)
    for plen in (1, 4, 16):
        got = ps.pattern_scan_rowgroup(x, pat, plen)
        want = ps.pattern_scan_rowgroup_plain(x, pat, plen)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"pattern_scan_rowgroup on row-group {g} "
                               f"P={plen}: card != plain")
    log(f"[derive] pattern_scan_rowgroup == plain on the widest row-group "
        f"({tuple(x.shape)}, {lens.size} live rows)")
    return store, stamps


# -- phase 8 ---------------------------------------------------------------
def columnar_serve(store: ColumnStore, stamps: np.ndarray,
                   checked: dict, results: dict) -> None:
    lo, hi = int(stamps.min()), int(stamps.max()) + 1
    timed = ("literal, time range",
             QueryRequest(b"web archive", HeaderFilter(time_range=(lo, hi)),
                          top_k=len(store)))
    requests = REQUESTS + [timed]
    obs.reset()
    ps.launches = ps.rowgroup_launches = 0
    engine = QueryEngine.from_store(store, device="cuda")
    t0 = time.perf_counter()
    with IndexQueryService(engine.index, engine=engine) as svc:
        responses = svc.serve([r for _, r in requests])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    results["rowgroup_launches"] = ps.rowgroup_launches
    if ps.launches:
        raise RuntimeError(f"the columnar path launched the batch scan "
                           f"{ps.launches} times")
    results["rowgroup_shape"] = dominant_shape("find_pattern_mask_rowgroup")
    c = obs.snapshot().counters
    split = {k: c.get(f"stage.find_pattern_mask_rowgroup.{k}_us", 0) / 1e6
             for k in ("h2d", "kernel", "d2h")}
    in_range = set(np.flatnonzero((stamps >= lo) & (stamps < hi)).tolist())
    row_of = {(store.shard_paths[int(s)], int(o)): i
              for i, (s, o) in enumerate(zip(store.shard_id, store.offset))}
    served = []
    for (label, req), resp in zip(requests, responses):
        if req is timed[1]:
            oracle, want = checked["selective literal"]
            oracle = {k: v for k, v in oracle.items()
                      if row_of[k] in in_range}
            want = [k for k in want if k[0] in in_range]
        else:
            oracle, want = checked[label]
        got = {(h.shard, h.offset): h.n_matches for h in resp.hits}
        if got != oracle or resp.total_matches != len(oracle):
            raise RuntimeError(f"columnar request {label!r}: {len(got)} "
                               f"hits differ from the {len(oracle)}-record "
                               f"oracle")
        if hit_keys(resp.hits) != want:
            raise RuntimeError(f"columnar request {label!r}: hits differ "
                               f"from phase 6's")
        served.append({"label": label, "hits": len(got),
                       "latency_ms": resp.latency_s * 1e3})
        log(f"[columnar] {label} {req.pattern!r}: {len(got)} records == "
            f"oracle == phase 6, {resp.latency_s * 1e3:.3f} ms")
    if engine.header_mask(HeaderFilter(time_range=(0, lo))).any():
        raise RuntimeError("an empty time range selected records")
    stats = dict(engine.stats)
    results["columnar"] = {"requests": served, "seconds": dt,
                           "stats": stats, "scan_split_s": split,
                           "rowgroup_launches": ps.rowgroup_launches}
    log(f"[columnar] {len(requests)} requests in {dt:.3f} s; "
        f"{ps.rowgroup_launches} pattern_scan_rowgroup launches; scan split "
        f"(s): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; engine {stats}")


def profile_broad(store: ColumnStore, results: dict) -> None:
    """Where the broad literal's columnar search spends its time: one
    more run under ``cProfile`` (host functions by own time; the scan
    wrapper's device work shows up inside its copies and synchronizes)."""
    pattern = REQUESTS[0][1].pattern
    engine = QueryEngine.from_store(store, device="cuda")
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    n = len(engine.search(pattern))
    torch.cuda.synchronize()
    prof.disable()
    dt = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    rows = sorted(((f"{Path(f).name}:{line}({name})", tt, ct)
                   for (f, line, name), (_, _, tt, ct, _) in stats.items()),
                  key=lambda r: -r[1])[:12]
    results["broad_profile"] = {"seconds": dt, "hits": n,
                                "top_tottime_s": rows}
    log(f"[profile] broad literal, columnar, under cProfile: {n} hits in "
        f"{dt:.3f} s; own time (s), cumulative (s):")
    for name, tt, ct in rows:
        log(f"[profile]   {tt:8.4f} {ct:8.4f}  {name}")


# -- phase 9 ---------------------------------------------------------------
def flipped_copy(index: CdxIndex, cdx: Path, digest_rows=(),
                 sig_rows=()) -> CdxIndex:
    """A fresh load of the saved index with the given rows' digests, and
    the first signature word of ``sig_rows``, flipped in one bit."""
    out = CdxIndex.load(str(cdx))
    out.digest = out.digest.copy()
    out.digest[list(digest_rows)] ^= 1
    out.signatures = out.signatures.copy()
    out.signatures[list(sig_rows), 0] ^= np.uint64(1)
    return out


def verify_phase(index: CdxIndex, workdir: Path, results: dict) -> None:
    n = len(index)
    obs.reset()
    ad.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ok = verify_index(index, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    results["adler32_launches"] = ad.launches
    if len(ok) != n or not all(ok):
        raise RuntimeError(f"verify_index: {ok.count(False)} of {len(ok)} "
                           f"records failed on an intact index")
    c = obs.snapshot().counters
    split = {k: c.get(f"stage.adler32_batch.{k}_us", 0) / 1e6
             for k in ("h2d", "kernel", "d2h")}
    results["adler32_shape"] = dominant_shape("adler32_batch")
    log(f"[verify] verify_index: all {n} records True in {dt:.3f} s = "
        f"{n / dt:.1f} records/s; {ad.launches} adler32 launches; "
        f"adler32_batch split (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; peak device memory {peak} bytes")

    rng = np.random.default_rng(SEED + 5)
    flips = sorted(rng.choice(n, 3, replace=False).tolist())
    t1 = time.perf_counter()
    bad = verify_index(flipped_copy(index, workdir / "corpus.cdx", flips),
                       device="cuda")
    dt_flip = time.perf_counter() - t1
    if [i for i, v in enumerate(bad) if not v] != flips:
        raise RuntimeError(f"verify_index with digests {flips} flipped "
                           f"returned False at "
                           f"{[i for i, v in enumerate(bad) if not v]}")
    log(f"[verify] digests of rows {flips} flipped: exactly those False "
        f"({dt_flip:.3f} s)")

    sig_row = int(rng.integers(n))
    ds.launches = 0
    obs.reset()
    t2 = time.perf_counter()
    sig_ok = verify_index(flipped_copy(index, workdir / "corpus.cdx",
                                       sig_rows=[sig_row]),
                          check_signatures=True, device="cuda")
    torch.cuda.synchronize()
    dt_sig = time.perf_counter() - t2
    results["verify_digest_sig_launches"] = ds.launches
    if [i for i, v in enumerate(sig_ok) if not v] != [sig_row]:
        raise RuntimeError(f"verify_index(check_signatures=True) with the "
                           f"signature of row {sig_row} flipped returned "
                           f"False at "
                           f"{[i for i, v in enumerate(sig_ok) if not v]}")
    c = obs.snapshot().counters
    sig_split = {k: c.get(f"stage.digest_signature_batch.{k}_us", 0) / 1e6
                 for k in ("h2d", "kernel", "d2h", "fold")}
    log(f"[verify] check_signatures=True over all {n} records: every "
        f"digest and signature True but row {sig_row}'s flipped signature "
        f"bit, {dt_sig:.3f} s = {n / dt_sig:.1f} records/s; {ds.launches} "
        f"digest_sig launches; split (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in sig_split.items()))

    # verify_digests_bulk on mixed headers == verify_digest item by item
    datas, headers = [], []
    readers = {}
    for k, row in enumerate(sorted(rng.choice(n, min(DIGEST_SAMPLE, n),
                                              replace=False).tolist())):
        sid = int(index.shard_id[row])
        if sid not in readers:
            readers[sid] = RandomAccessReader(index.shard_paths[sid],
                                              parse_http=False)
        d = readers[sid].read(int(index.offset[row])).content
        datas.append(d)
        headers.append([
            block_digest(d, "sha1"), block_digest(d, "md5"),
            block_digest(d, "crc32"), block_digest(d, "adler32"),
            f"adler32:{zlib.adler32(d) ^ (1 << (k % 8 + 3)):08x}",
            "adler32:not-hex", "sha1:" + "A" * 32, "crc32:zz"][k % 8])
    for reader in readers.values():
        reader.close()
    got = verify_digests_bulk(datas, headers, device="cuda")
    want = [verify_digest(d, h) for d, h in zip(datas, headers)]
    if got != want or sum(want) != sum(1 for i in range(len(datas))
                                       if i % 8 < 4):
        raise RuntimeError("verify_digests_bulk != verify_digest on mixed "
                           "headers")
    results["verify"] = {
        "records": n, "seconds": dt, "records_per_s": n / dt,
        "adler32_launches": results["adler32_launches"],
        "adler32_split_s": split, "peak_device_bytes": peak,
        "flipped_rows": flips, "flipped_seconds": dt_flip,
        "signatures_seconds": dt_sig, "signatures_split_s": sig_split,
        "signature_flipped_row": sig_row,
        "digest_sig_launches": results["verify_digest_sig_launches"]}
    log(f"[verify] verify_digests_bulk == verify_digest on {len(datas)} "
        f"records with sha1/md5/crc32/adler32/wrong/malformed headers")


# -- phase 10 --------------------------------------------------------------
def gateway_phase(index: CdxIndex, checked: dict, results: dict) -> None:
    labels = {id(r): label for label, r in REQUESTS}
    rng = np.random.default_rng(SEED + 6)
    orders = [rng.permutation(len(REQUESTS) * GW_REPEATS) % len(REQUESTS)
              for _ in range(GW_CLIENTS)]
    obs.reset()
    ps.multi_launches = 0
    responses: list = []
    lock = threading.Lock()
    errors: list = []
    t0 = time.perf_counter()
    with ArchiveGateway(index, shards=GW_SHARDS, device="cuda") as gw:
        def client(order) -> None:
            try:
                futs = [(REQUESTS[i][1], gw.submit(REQUESTS[i][1]))
                        for i in order]
                done = [(req, f.result(600)) for req, f in futs]
                with lock:
                    responses.extend(done)
            except BaseException as exc:  # re-raised below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(o,))
                   for o in orders]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        snap = gw.metrics.snapshot(gw.cache)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"gateway clients failed: {errors[:1]}")
    results["multi_launches"] = ps.multi_launches
    want = GW_CLIENTS * GW_REPEATS * len(REQUESTS)
    if len(responses) != want or snap["responses"] != want:
        raise RuntimeError(f"gateway resolved {len(responses)} of {want}")
    for req, resp in responses:
        oracle, keys = checked[labels[id(req)]]
        if hit_keys(resp.hits) != keys or resp.total_matches != len(oracle):
            raise RuntimeError(f"gateway request {labels[id(req)]!r}: hits "
                               f"differ from phase 6's")
    lat = sorted(r.latency_s for _, r in responses)
    c = obs.snapshot().counters
    split = {k: c.get(f"stage.find_pattern_masks_multi.{k}_us", 0) / 1e6
             for k in ("h2d", "kernel", "d2h")}
    results["gateway_shape"] = dominant_shape("find_pattern_masks_multi")
    keep = ("requests", "responses", "coalesced", "unique_scans",
            "scan_batches", "kernel_dispatches", "dispatches_per_request",
            "records_scanned", "records_fetched", "host_scans",
            "latency_p50_ms", "latency_p99_ms", "cache_hit_rate", "errors")
    results["gateway"] = {
        "submissions": want, "seconds": dt, "requests_per_s": want / dt,
        "metrics": {k: snap[k] for k in keep},
        "stages": snap.get("stages", {}), "scan_split_s": split,
        "multi_launches": ps.multi_launches}
    log(f"[gateway] {GW_SHARDS} shards, {GW_CLIENTS} clients x "
        f"{GW_REPEATS} x {len(REQUESTS)} requests = {want} submissions in "
        f"{dt:.3f} s = {want / dt:.2f} requests/s; every hit list == phase "
        f"6's; latency p50 {snap['latency_p50_ms']:.3f} ms, p99 "
        f"{snap['latency_p99_ms']:.3f} ms (responses: p50 "
        f"{lat[len(lat) // 2] * 1e3:.3f} ms); coalesced "
        f"{snap['coalesced']}, unique scans {snap['unique_scans']}, "
        f"kernel_dispatches {snap['kernel_dispatches']}, "
        f"dispatches_per_request {snap['dispatches_per_request']:.4f}, "
        f"cache hit rate {snap['cache_hit_rate']:.4f}; "
        f"{ps.multi_launches} pattern_scan_batch_multi launches; scan split "
        f"(s): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    for line in render_stage_table(snap.get("stages", {})).splitlines():
        log(f"[gateway]   {line}")
    if min(snap["coalesced"], snap["kernel_dispatches"],
           ps.multi_launches) <= 0:
        raise RuntimeError("the gateway neither coalesced nor launched")


def rowgroup_multi_phase(store: ColumnStore, results: dict) -> None:
    """find_pattern_masks_multi_rowgroup on the store's fullest row-group
    of phase 8's dominant width, phase 8's kernel patterns assigned to its
    rows in turn, against find_pattern_mask_rowgroup once per pattern."""
    engine = QueryEngine.from_store(store, device="cuda")
    pats = []
    for _, req in REQUESTS:
        plan = (engine.plan_regex(req.pattern) if req.regex
                else engine.plan(req.pattern))
        if plan.kernel_pattern is not None and plan.kernel_pattern not in pats:
            pats.append(plan.kernel_pattern)
    _, gwidth = results["rowgroup_shape"]
    g = int(max(np.flatnonzero(store.rg_width == gwidth),
                key=lambda i: int(store.rg_rows[i])))
    matrix, _, lens = store.rowgroup(g)
    row_pats = [pats[i % len(pats)] for i in range(lens.size)]
    ps.rowgroup_multi_launches = 0
    got = find_pattern_masks_multi_rowgroup(matrix, lens, row_pats,
                                            device="cuda")
    results["rowgroup_multi_launches"] = ps.rowgroup_multi_launches
    for j, p in enumerate(pats):
        want = find_pattern_mask_rowgroup(matrix, lens, p, device="cuda")
        rows = np.arange(j, lens.size, len(pats))
        if not np.array_equal(got[rows], want[rows]):
            raise RuntimeError(f"find_pattern_masks_multi_rowgroup on "
                               f"row-group {g}, pattern {p!r}: != "
                               f"find_pattern_mask_rowgroup")
    del matrix
    results["rowgroup_multi_group"] = [g, int(lens.size), gwidth]
    log(f"[gateway] find_pattern_masks_multi_rowgroup on row-group {g} "
        f"({lens.size} rows x W={gwidth}, {len(pats)} patterns of lengths "
        f"{sorted(len(p) for p in pats)}): == find_pattern_mask_rowgroup "
        f"per pattern, {int(got.sum())} matches, "
        f"{results['rowgroup_multi_launches']} launch")


# -- phase 11 --------------------------------------------------------------
def response_payloads(path: str, n: int) -> list[bytes]:
    """The HTTP bodies of the first ``n`` response records of a shard."""
    out = []
    for rec in FastWARCIterator(path):
        if rec.record_type == WarcRecordType.response:
            out.append(bytes(rec.payload_view()))
            if len(out) == n:
                break
    return out


def span_sum(name: str) -> float:
    h = obs.snapshot().histograms.get(f"span.{name}_s")
    return h["sum"] if h else 0.0


def decode_profile(params, cfg, batch: int, seq: int, length: int) -> dict:
    """Device time of the engine's decode steps: 16 ``decode_step`` calls
    on a batch-``batch`` cache holding ``length`` positions, timed on the
    host clock, then again under ``torch.profiler`` for the device time
    by kernel; busy share = device time / unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    def steps(cache, tok):
        for _ in range(16):
            logits, cache = tf.decode_step(params, cache, tok, cfg)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()

    with torch.inference_mode():
        walls = []
        for run in range(3):  # run 0 warms up
            cache = tf.init_cache(cfg, batch, seq)
            cache["length"] = length
            tok = torch.full((batch,), BOS_ID, device="cuda")
            t0 = time.perf_counter()
            steps(cache, tok)
            walls.append(time.perf_counter() - t0)
        cache["length"] = length
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            steps(cache, tok)
    wall = min(walls[1:])
    by_kernel: dict = {}  # device-side events only: an aten op's row
    for e in prof.key_averages():  # repeats its kernels' device time
        t = e.self_device_time_total
        if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + t / 1e6
    device = sum(by_kernel.values())
    flash = sum(t for k, t in by_kernel.items() if "flash_fwd_kernel" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"steps": 16, "cache_length": length, "wall_s": wall,
            "device_s": device if device else None,
            "busy_share": device / wall if device else None,
            "flash_s": flash, "top_kernels_s": top}


def lm_phase(paths: list[str], results: dict) -> None:
    """fastwarc_lm at full width on the card: the serve_1k prefill
    through ``forward`` and the serving engine, both through the
    flash-attention kernel."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[lm] torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}")
    spec = get_spec("fastwarc_lm")
    cfg = spec.config
    batch = spec.shape("serve_1k").params["global_batch"]
    seq = spec.shape("serve_1k").params["seq_len"]
    rng = np.random.default_rng(SEED + 11)
    payloads = response_payloads(paths[0], 512)
    pick = rng.choice(len(payloads), batch + LM_REQUESTS, replace=False)
    t0 = time.perf_counter()
    params = tf.init_params(cfg, generator=torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params.parameters())
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} q heads / {cfg.n_kv_heads} kv heads, d_head "
        f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}: "
        f"{n_params} parameters (seeded) in {time.perf_counter() - t0:.3f} s")
    if n_params != cfg.param_count():
        raise RuntimeError(f"{n_params} parameters, config says "
                           f"{cfg.param_count()}")

    # (a) prefill: the serve_1k batch through forward
    tokens = np.stack([np.concatenate(([BOS_ID], encode(payloads[i][:seq - 1])))
                       for i in pick[:batch]])
    tok_d = torch.from_numpy(tokens).cuda()
    fa.launches = 0
    times = []
    with torch.inference_mode():
        for run in range(LM_PREFILL_RUNS + 1):  # run 0 warms up
            t0 = time.perf_counter()
            logits, _ = tf.forward(params, tok_d, cfg)
            torch.cuda.synchronize()
            if run:
                times.append(time.perf_counter() - t0)
    prefill_launches = fa.launches
    if prefill_launches <= 0:
        raise RuntimeError("forward did not launch flash_attention")
    if logits.shape != (batch, seq, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise RuntimeError(f"prefill logits {tuple(logits.shape)} not finite "
                           f"or of the wrong shape")
    prefill_s = float(np.median(times))
    cpu_params = tf.init_params(cfg, generator=torch.Generator().manual_seed(
        SEED), device="cpu")
    t0 = time.perf_counter()
    with torch.inference_mode():
        cpu_logits, _ = tf.forward(cpu_params, torch.from_numpy(tokens[:1]),
                                   cfg)
    cpu_s = time.perf_counter() - t0
    del cpu_params
    row0 = logits[0].cpu()
    diff = float((row0 - cpu_logits[0]).abs().max())
    try:
        torch.testing.assert_close(row0, cpu_logits[0], rtol=2e-4, atol=2e-4)
    except AssertionError as exc:
        raise RuntimeError(f"prefill row 0: card != CPU forward: {exc}") \
            from None
    log(f"[lm] (a) prefill forward [{batch}, {seq}]: median of "
        f"{LM_PREFILL_RUNS} {prefill_s * 1e3:.3f} ms (runs "
        f"{', '.join(f'{t * 1e3:.3f}' for t in times)} ms) = "
        f"{batch * seq / prefill_s:.1f} prefill tokens/s; "
        f"{prefill_launches} flash_attention launches "
        f"({cfg.n_layers} a forward); row 0 logits == CPU forward "
        f"({cpu_s:.3f} s), max |card - CPU| = {diff:.3g}")

    # (b) the serving engine
    prompts = [payloads[i][:int(rng.integers(64, 257))]
               for i in pick[batch:]]
    requests = [Request(p, max_new_tokens=LM_NEW_TOKENS) for p in prompts]
    engine = ServeEngine(cfg, params, batch_size=batch, max_seq=seq,
                         temperature=0.0, device="cuda")
    prev = trace.enable(True)
    spans0 = {k: span_sum(k) for k in ("serve.prefill", "serve.decode")}
    torch.cuda.reset_peak_memory_stats()
    before = fa.launches
    t0 = time.perf_counter()
    try:
        done = engine.serve(requests)
    finally:
        trace.enable(prev)
    wall = time.perf_counter() - t0
    engine_launches = fa.launches - before
    peak = torch.cuda.max_memory_allocated()
    if engine_launches <= 0:
        raise RuntimeError("the engine did not launch flash_attention")
    spans = {k: span_sum(k) - spans0[k] for k in spans0}
    generated = engine.stats["tokens_generated"]
    mismatch = []
    chain_forwards = 0
    with torch.inference_mode():
        for j, r in enumerate(done):
            if not r.done or not 0 < len(r.out_tokens) <= LM_NEW_TOKENS or not \
                    all(0 <= t < cfg.vocab for t in r.out_tokens):
                raise RuntimeError(f"request {r.prompt[:20]!r}: done "
                                   f"{r.done}, {len(r.out_tokens)} tokens")
            # the engine prefills its batch to the longest prompt: a slot
            # whose prompt ends k tokens earlier generates k tokens there
            # that it does not record (the reference's loop), so its first
            # recorded token is forward's greedy continuation k + 1 tokens
            # on (k = 0, one argmax, for the batch's longest prompt)
            chunk = done[j - j % batch:j - j % batch + batch]
            longest = max(len(c.prompt) for c in chunk)
            ids = [BOS_ID, *encode(r.prompt).tolist()]
            for _ in range(longest - len(r.prompt) + 1):
                last, _ = tf.forward(params, torch.tensor([ids]).cuda(), cfg)
                want = int(last[0, -1].argmax())
                ids.append(want)
                chain_forwards += 1
            if r.out_tokens[0] != want:
                gap = float(last[0, -1, want] - last[0, -1, r.out_tokens[0]])
                mismatch.append((len(r.prompt), longest, r.out_tokens[0],
                                 want, gap))
    if mismatch:
        raise RuntimeError(f"first tokens != forward's greedy argmax (prompt "
                           f"bytes, batch's longest, engine, forward, logit "
                           f"gap): {mismatch}")
    prof = decode_profile(params, cfg, batch, seq, 256)
    if prof["device_s"] is None:
        log("[lm] decode profile: the profiler saw no device time (busy "
            "share not measured)")
    else:
        log(f"[lm] decode profile, 16 decode_steps at cache length 256: "
            f"wall {prof['wall_s'] * 1e3:.3f} ms, device "
            f"{prof['device_s'] * 1e3:.3f} ms, busy share "
            f"{prof['busy_share']:.4f}; flash_attention "
            f"{prof['flash_s'] * 1e3:.3f} ms; top kernels (ms): "
            + "; ".join(f"{k[:60]} {t * 1e3:.3f}"
                        for k, t in prof["top_kernels_s"]))
    lens = [len(p) for p in prompts]
    results["lm"] = {
        "decode_profile": prof,
        "model": cfg.name, "parameters": n_params,
        "prefill_shape": [batch, seq], "prefill_runs_s": times,
        "prefill_s": prefill_s,
        "prefill_tokens_per_s": batch * seq / prefill_s,
        "row0_max_abs_diff_vs_cpu": diff,
        "engine_requests": len(done), "prompt_bytes": [min(lens), max(lens)],
        "tokens_generated": generated, "engine_wall_s": wall,
        "serve_prefill_s": spans["serve.prefill"],
        "serve_decode_s": spans["serve.decode"],
        "decode_tokens_per_s": generated / spans["serve.decode"],
        "engine_tokens_per_s": generated / engine.stats["decode_s"],
        "peak_device_bytes": peak,
        "flash_launches": {"prefill": prefill_launches,
                           "engine": engine_launches}}
    results["flash_launches"] = prefill_launches + engine_launches
    log(f"[lm] (b) ServeEngine(batch_size={batch}, max_seq={seq}, greedy): "
        f"{len(done)} requests of {min(lens)}-{max(lens)} payload bytes, "
        f"{generated} tokens generated in {wall:.3f} s; serve.prefill "
        f"{spans['serve.prefill']:.3f} s, serve.decode "
        f"{spans['serve.decode']:.3f} s = {generated / spans['serve.decode']:.1f}"
        f" decode tokens/s ({generated / engine.stats['decode_s']:.1f} tokens/s"
        f" over the engine's time); {engine_launches} flash_attention launches; "
        f"peak device memory {peak} bytes; every first token == forward's "
        f"greedy argmax ({chain_forwards} check forwards)")
    results["lm"]["phase_s"] = time.perf_counter() - t_phase
    log(f"[lm] phase 11 in {results['lm']['phase_s']:.3f} s")


def timed_err(name: str, kernel, plain) -> int:
    """max |kernel - plain| on the inputs the kernels line times; raises
    unless the two agree exactly."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    d = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    if d:
        raise RuntimeError(f"{name} at its timed shape: max |kernel - "
                           f"plain| = {d}")
    return d


def kernel_line(results: dict, store: ColumnStore) -> dict:
    """Each kernel at its main path's dominant shape: checked against its
    plain version on the very inputs it is then timed on."""
    rng = np.random.default_rng(SEED + 1)
    err = dict(results["max_abs_err"])

    def agree(name, kernel, plain):
        err[name] = max(err[name], timed_err(name, kernel, plain))

    rows, width = results["pattern_scan_shape"]
    x, pat = scan_inputs(rng, rows, width)
    agree("pattern_scan", lambda: ps.pattern_scan_batch(x, pat, 16),
          lambda: ps.pattern_scan_plain(x, pat, 16))
    ms = time_ms(lambda: ps.pattern_scan_batch(x, pat, 16))
    plain = time_ms(lambda: ps.pattern_scan_plain(x, pat, 16), 20)
    b_scan, by_scan = bound(*scan_cost(rows, width, 16))
    drows, dwidth = results["digest_sig_shape"]
    kblock = min(ds.BLOCK, dwidth)
    y = digest_inputs(rng, drows, dwidth)
    agree("digest_sig", lambda: ds.digest_sig_partials_batch(
        y, n=4, block=kblock), lambda: ds.digest_sig_plain(
        y, n=4, block=kblock))
    dms = time_ms(lambda: ds.digest_sig_partials_batch(y, n=4, block=kblock))
    dplain = time_ms(lambda: ds.digest_sig_plain(y, n=4, block=kblock), 20)
    b_dig, by_dig = bound(*digest_cost(drows, dwidth, kblock, 4))
    # the row-group scan on the store's fullest row-group of phase 8's
    # dominant width: the live rows, as the wrapper copies them
    _, gwidth = results["rowgroup_shape"]
    g = max(np.flatnonzero(store.rg_width == gwidth),
            key=lambda i: int(store.rg_rows[i]))
    matrix, _, lens = store.rowgroup(int(g))
    z = torch.from_numpy(np.array(matrix[:lens.size])).cuda()
    del matrix
    zpat = np.frombuffer(b"nginx/1.25\r\nDate", np.uint8)
    agree("pattern_scan_rowgroup",
          lambda: ps.pattern_scan_rowgroup(z, zpat, 16),
          lambda: ps.pattern_scan_rowgroup_plain(z, zpat, 16))
    gms = time_ms(lambda: ps.pattern_scan_rowgroup(z, zpat, 16))
    gplain = time_ms(lambda: ps.pattern_scan_rowgroup_plain(z, zpat, 16), 20)
    b_grp, by_grp = bound(*rowgroup_cost(lens.size, gwidth, 16))
    # the gateway's multi-pattern scan at its dominant bucket: mixed
    # pattern lengths 1..16, a quarter of the rows inert padding
    mrows, mwidth = results["gateway_shape"]
    mx, mp, mn, mlen = multi_inputs(rng, mrows, mwidth, 16,
                                    max(1, mrows - mrows // 4))
    agree("pattern_scan_batch_multi",
          lambda: ps.pattern_scan_batch_multi(mx, mp, mn, mlen),
          lambda: ps.pattern_scan_multi_plain(mx, mp, mn, mlen))
    mms = time_ms(lambda: ps.pattern_scan_batch_multi(mx, mp, mn, mlen))
    mplain = time_ms(lambda: ps.pattern_scan_multi_plain(mx, mp, mn, mlen),
                     20)
    b_mul, by_mul = bound(*multi_cost(mrows, mwidth, 16, mn.cpu().numpy()))
    # the row-group twin on phase 10's row-group: phase 8's patterns in turn
    g, grows, _ = results["rowgroup_multi_group"]
    engine = QueryEngine.from_store(store, device="cuda")
    pats = []
    for _, req in REQUESTS:
        plan = (engine.plan_regex(req.pattern) if req.regex
                else engine.plan(req.pattern))
        if plan.kernel_pattern is not None and plan.kernel_pattern not in pats:
            pats.append(plan.kernel_pattern)
    matrix, _, _ = store.rowgroup(g)
    gx = torch.from_numpy(np.array(matrix[:grows])).cuda()
    del matrix
    gp = np.zeros((grows, 16), np.uint8)
    gn = np.zeros(grows, np.int32)
    for r in range(grows):
        p = pats[r % len(pats)]
        gp[r, :len(p)] = np.frombuffer(p, np.uint8)
        gn[r] = len(p)
    gp_t, gn_t = torch.from_numpy(gp).cuda(), torch.from_numpy(gn).cuda()
    glen = int(gn.max())
    agree("pattern_scan_rowgroup_multi",
          lambda: ps.pattern_scan_rowgroup_multi(gx, gp_t, gn_t, glen),
          lambda: ps.pattern_scan_rowgroup_multi_plain(gx, gp_t, gn_t,
                                                       glen))
    rms = time_ms(lambda: ps.pattern_scan_rowgroup_multi(gx, gp_t, gn_t,
                                                         glen))
    rplain = time_ms(lambda: ps.pattern_scan_rowgroup_multi_plain(
        gx, gp_t, gn_t, glen), 20)
    b_rmul, by_rmul = bound(*multi_cost(grows, gwidth, PAD, gn))
    # adler32 at verify's dominant width bucket
    arows, awidth = results["adler32_shape"]
    ax = adler_inputs(rng, arows, awidth)
    agree("adler32", lambda: ad.adler32_partials_batch(ax),
          lambda: ad.adler32_plain(ax))
    ams = time_ms(lambda: ad.adler32_partials_batch(ax))
    aplain = time_ms(lambda: ad.adler32_plain(ax), 20)
    b_ad, by_ad = bound(*adler_cost(arows, awidth))
    # flash_attention: phase 4's prefill and decode cases, checked on the
    # inputs they were timed on
    fl, fd = results["flash"]["prefill"], results["flash"]["decode Sk=1000"]
    return {"kernels": [
        {"name": "pattern_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/pattern_scan/csrc/pattern_scan.cu",
         "replaces": "src/repro/kernels/pattern_scan/pattern_scan.py:122",
         "launches": results["pattern_scan_launches"],
         "max_abs_err": err["pattern_scan"],
         "ms": ms, "plain_ms": plain, "bound_ms": b_scan,
         "bound_by": by_scan, "library_ms": None,
         "shape": [rows, width + 16], "pattern_len": 16},
        {"name": "digest_sig", "route": "cuda",
         "source": "src/repro_torch/kernels/digest_sig/csrc/digest_sig.cu",
         "replaces": "src/repro/kernels/digest_sig/digest_sig.py:84",
         "launches": (results["digest_sig_launches"]
                      + results["derive_digest_sig_launches"]
                      + results["verify_digest_sig_launches"]),
         "max_abs_err": err["digest_sig"],
         "ms": dms, "plain_ms": dplain, "bound_ms": b_dig,
         "bound_by": by_dig, "library_ms": None,
         "shape": [drows, dwidth + 128],
         "launches_by_phase": {
             "build": results["digest_sig_launches"],
             "derive": results["derive_digest_sig_launches"],
             "verify": results["verify_digest_sig_launches"]}},
        {"name": "pattern_scan_rowgroup", "route": "cuda",
         "source": "src/repro_torch/kernels/pattern_scan/csrc/pattern_scan.cu",
         "replaces": "src/repro/kernels/pattern_scan/pattern_scan.py:185",
         "launches": results["rowgroup_launches"],
         "max_abs_err": err["pattern_scan_rowgroup"],
         "ms": gms, "plain_ms": gplain, "bound_ms": b_grp,
         "bound_by": by_grp, "library_ms": None,
         "shape": [int(lens.size), gwidth + PAD], "pattern_len": 16},
        {"name": "pattern_scan_batch_multi", "route": "cuda",
         "source": "src/repro_torch/kernels/pattern_scan/csrc/pattern_scan.cu",
         "replaces": "src/repro/kernels/pattern_scan/pattern_scan.py:84",
         "launches": results["multi_launches"],
         "max_abs_err": err["pattern_scan_batch_multi"],
         "ms": mms, "plain_ms": mplain, "bound_ms": b_mul,
         "bound_by": by_mul, "library_ms": None,
         "shape": [mrows, mwidth + 16], "pattern_lens": "1..16"},
        {"name": "pattern_scan_rowgroup_multi", "route": "cuda",
         "source": "src/repro_torch/kernels/pattern_scan/csrc/pattern_scan.cu",
         "replaces": "src/repro/kernels/pattern_scan/pattern_scan.py:216",
         "launches": results["rowgroup_multi_launches"],
         "max_abs_err": err["pattern_scan_rowgroup_multi"],
         "ms": rms, "plain_ms": rplain, "bound_ms": b_rmul,
         "bound_by": by_rmul, "library_ms": None,
         "shape": [grows, gwidth + PAD],
         "pattern_lens": sorted({len(p) for p in pats})},
        {"name": "adler32", "route": "cuda",
         "source": "src/repro_torch/kernels/adler32/csrc/adler32.cu",
         "replaces": "src/repro/kernels/adler32/adler32.py:51",
         "launches": results["adler32_launches"],
         "max_abs_err": err["adler32"],
         "ms": ams, "plain_ms": aplain, "bound_ms": b_ad,
         "bound_by": by_ad, "library_ms": None,
         "shape": [arows, awidth]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:93",
         "launches": results["flash_launches"],
         "max_abs_err": err["flash_attention"],
         "ms": fl["ms"], "plain_ms": fl["plain_ms"],
         "bound_ms": fl["bound_ms"], "bound_by": fl["bound_by"],
         "library_ms": fl["library_ms"],
         "library": "scaled_dot_product_attention(is_causal=True, "
                    "enable_gqa=True)",
         "shape": [fl["shape_q"], fl["shape_kv"]], "dtype": "float32",
         "max_abs_err_bf16": err["flash_attention_bf16"],
         "launches_by_phase": results["lm"]["flash_launches"],
         "decode": {k: fd[k] for k in ("shape_q", "shape_kv", "ms",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")}},
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
    # full fp32 matrix products for every plain version and the LM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    rowgroup_checks(results)
    multi_checks(results)
    adler_checks(results)
    flash_checks(results)
    index = main_build(paths, workdir, results)
    checked = serve(index, paths, results)
    store, stamps = derive_phase(paths, workdir, index, results)
    columnar_serve(store, stamps, checked, results)
    profile_broad(store, results)
    verify_phase(index, workdir, results)
    gateway_phase(index, checked, results)
    rowgroup_multi_phase(store, results)
    lm_phase(paths, results)

    launches = {"digest_sig (build)": results["digest_sig_launches"],
                "pattern_scan (serve)": results["pattern_scan_launches"],
                "digest_sig (derive)": results["derive_digest_sig_launches"],
                "pattern_scan_rowgroup (columnar serve)":
                    results["rowgroup_launches"],
                "adler32 (verify)": results["adler32_launches"],
                "digest_sig (verify, check_signatures)":
                    results["verify_digest_sig_launches"],
                "pattern_scan_batch_multi (gateway)":
                    results["multi_launches"],
                "pattern_scan_rowgroup_multi (gateway, row-group)":
                    results["rowgroup_multi_launches"],
                "flash_attention (LM prefill)":
                    results["lm"]["flash_launches"]["prefill"],
                "flash_attention (LM engine)":
                    results["lm"]["flash_launches"]["engine"]}
    log(f"[launches] main paths: {launches}")
    if min(launches.values()) <= 0:
        raise RuntimeError("a kernel of a main path was never launched")

    line = kernel_line(results, store)
    store.close()
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
