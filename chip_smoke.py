"""End-to-end smoke run of ``repro_torch`` on one NVIDIA GPU (H100, sm_90a).

Drives the port's paths through their public entry points on the card —
synthetic gzip corpus → ``build_index`` → ``IndexQueryService`` literal
and regex searches over CDX+seek; the same corpus → ``columnar.derive``
→ ``QueryEngine.from_store`` → the same searches over the ``.repcol``
row-groups; ``verify_index`` over the whole index; the sharded
``ArchiveGateway`` serving the searches to concurrent clients; the
``fastwarc_lm`` byte-level LM at full width prefilling and serving prompts
taken from the corpus; Qwen3-30B-A3B, a mixture of experts, at full width
in bf16 doing the same — and holds every kernel of those paths against its
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
   pad rows, ``adler32_partials_batch`` with all-0xFF and empty rows;
   ``digest_sig``'s general body at n = 24 and 129 and block 4096;
   ``pattern_scan_rowgroup`` where its early exit never fires;
   ``pattern_scan_batch_multi`` and ``pattern_scan_rowgroup_multi`` with
   ``lens[r] < max_len`` on most rows and lengths outside [1, 16]);
5. main path: ``build_index(device="cuda")``; every digest against
   ``zlib.adler32``, a seeded sample of signatures against
   ``signature_of``, and a ``save``/``load`` round trip;
6. serve: ``IndexQueryService(device="cuda")`` over 8 requests, each
   held against the ``full_scan_search`` / ``full_scan_regex`` oracles;
   ``pattern_scan_batch`` launched once per kernel-path scan batch (each
   ``find_pattern_mask_batch`` call sweeps all its width buckets);
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
    seeded order; every hit list equal to phase 6's;
    ``pattern_scan_batch_multi`` launched once per ``gw.kernel_dispatch``
    span (one ``find_pattern_masks_multi`` call a chunk); then
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
    the batch's longer prompts; (c) the reduced ``fastwarc_lm`` (d_head
    32) on the card, its forward equal to the CPU's and its engine's
    greedy tokens equal to the CPU engine's;
12. process pool (run after phase 9), W = min(4, cpu count) workers
    started by ``forkserver`` (this process holds a CUDA context): (a)
    ``build_index(paths, workers=W, fused=False, device="cuda")``, the
    host path in the workers, every column equal to phase 5's and each
    of the W workers running one of the 4 shards; (b)
    ``build_index(paths, workers=W, device="cuda")``, the default on the
    card: ``digest_sig`` launched inside the workers, every column equal
    to phase 5's and
    its launches (counted in the workers, carried back through their
    stats slots into ``index.obs``) equal to phase 5's; (c) ``derive(
    paths, workers=W, device="cuda")``, the ``.repcol`` file
    byte-identical to phase 7's; (d) a supervised build with
    ``digest_sig`` in 2 workers, one killed before its 2nd result
    (``arm_worker_kill``):
    exactly 1 respawn and phase 5's columns; a 5th shard of garbage
    bytes quarantined by ``map_shards(supervise=True, poison_kills=2)``
    over a sweep that kills its worker on an unreadable shard, the other
    four partials merged equal to phase 5's index; no
    ``/dev/shm/repro_torch-shm-*`` segment left afterwards, and the
    forkserver and the resource tracker stopped and reaped (no process of
    the run outlives it);
13. codecs (run last): (a) the paper's Table 1 on this host,
    ``CorpusSpec(n_pages=600, seed=42)`` best of 3: records/s of
    ``WARCIOArchiveIterator`` (none and gzip only) and
    ``FastWARCIterator`` over {none, gzip, lz4, zstd} x {parse, +http,
    +http+checksum}, each pair yielding the same records, plus the
    response-only filtered pass (600 yielded, the rest in
    ``records_skipped``) as total records/s, gzip's and LZ4's parse with
    the members decoded in this process (``readahead=False``), and LZ4's
    and zstd's parse speedup over FastWARC+gzip; (b) ``build_index(device="cuda")`` over
    ``CorpusSpec(n_pages=2_000, seed=7)`` written once per codec: every
    column but the addressing ones equal across the shards, every
    digest == ``zlib.adler32``, a frame hint on every zstd row,
    ``digest_sig`` launched, the gzip and LZ4 sweeps decoded in a child
    process (``ProcessReadaheadDecoder``); (c) phase 6's requests over
    that index, each shard's hits equal to the oracle record by record
    (``pattern_scan_batch`` launched); (d) ``verify_index(device="cuda")``
    all True, then exactly the flipped LZ4 and zstd rows False
    (``adler32`` launched); (e) ``derive(device="cuda")`` of the LZ4 and
    zstd shards, its columns equal to (b)'s rows, and one columnar
    search equal to (c)'s hits (``digest_sig`` and
    ``pattern_scan_rowgroup`` launched); (f) ``build_index(tolerant=True,
    device="cuda")`` over ``corrupt_warc`` copies of the gzip and LZ4
    shards (``fraction=0.01, seed=0``): a non-empty ledger, every
    surviving row equal to the intact row of its record ID, no
    ``/dev/shm/repro_torch-shm-*`` segment left. Without ``zstandard``
    the zstd shard and cells are left out, and the run says so;
14. training (run after phase 11, before phase 13): (a) the attention
    backward kernel (``flash_attention_backward``, three launches: Δ,
    dK/dV, dQ) and the forward's lse path (``flash_attention_fwd_lse``)
    against ``attention_backward_plain`` / ``attention_plain`` (rtol =
    atol = 1e-4) at fastwarc_lm's train_1k attention (q [32, 12, 1024,
    64], k/v [32, 4, 1024, 64]), D = 16, 32 and 128, Sq < Sk, rows with
    no key (exactly 0 gradient, lse 1e30) and non-causal, each timed
    beside its plain version (and, at train_1k, the backward of
    ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``),
    then phase 4's f32 prefill time against its recorded range (failing
    outside it widened by twice its width); (b) one
    train step of the reduced fastwarc_lm on the card against the CPU
    port, loss, every gradient and the parameters after AdamW; (c)
    ``train_lm(arch="fastwarc_lm", batch=32, seq_len=1024, steps=20,
    ckpt_every=10, device="cuda")`` on phase 1's corpus at full width:
    the loss falls; tokens/s, step ms, peak device memory and launches a
    step (the backward's calls and the CUDA launches its C entry point
    reports); a second ``train_lm`` resumed from the step-10 checkpoint,
    its losses within rtol 1e-5 (and whether bit-identical); the loader
    restored from that checkpoint's cursor giving the uninterrupted
    loader's batches bit for bit, and ``WarcTokenLoader(workers=2)``
    (forkserver workers) the serial loader's 20 batches;
15. MoE serving (run last, after every earlier phase has released its
    device memory): (a) the reduced ``qwen3_moe_30b_a3b`` (f32, d_head
    16, 8 experts, top-2) on the card, forward over 2 x 64 tokens within
    rtol/atol 2e-4 of the CPU forward (logits and aux) and its engine's
    greedy tokens equal to the CPU engine's; (b) ``qwen3_moe_30b_a3b`` at
    full width (48 layers, d_model 2048, 32 query heads over 4 KV heads,
    128 experts top-8, d_ff 768, vocab 151,936; 30,532,110,336 bf16
    parameters drawn on the card from a CUDA ``torch.Generator``); (c)
    the ``serve_1k`` batch (8 x 1,024 tokens of corpus payloads) layer by
    layer: each layer's dropped assignments, and at layer 0 ``moe_apply``
    against ``moe_apply_plain`` on its normalised hidden states (the same
    experts and drops, outputs within 2^-6 x (|plain| + rms)); (d)
    ``forward`` over that batch, warm-up + 5 timed runs, 48 flash
    launches a forward, every one on the bf16 tensor-core prefill path
    (``prefill_tc``), finite
    logits, one profiled forward (#7's device time beside the total); (e)
    ``ServeEngine(batch_size=8, max_seq=1024, temperature=0)`` over 8
    corpus prompts of one length in 32-64 bytes, 16 new tokens each;
    against ``forward`` over the prompt and the engine's tokens (capacity
    factor E/k: nothing drops, as in the engine's batch-8 decode): every
    step's logits within 0.25 of forward's, every generated token
    forward's argmax wherever forward's top-2 gap exceeds 0.5, the
    near-ties counted; 48 flash launches a step, every one on the
    tensor-core decode path (``decode_tc``); a profiled decode window; (f)
    the model freed and the device memory back where it was.

The ``kernels`` line holds each kernel against its plain version on the
inputs it is then timed on, at its main path's dominant shape; besides,
each grouped kernel as one launch over a real call's width buckets
(``digest_sig`` over phase 5's first flush, ``pattern_scan_batch`` over
phase 6's scan batch with the most buckets, ``pattern_scan_batch_multi``
over phase 10's chunk with the most buckets), each early-exit scan where
its early exit never fires (``pattern_scan_rowgroup`` at the store's
shape, ``pattern_scan_batch`` and ``pattern_scan_batch_multi`` at their
dominant shapes, ``pattern_scan_rowgroup_multi`` at phase 10's
row-group's), ``pattern_scan_batch_multi`` and
``pattern_scan_rowgroup_multi`` with ``lens[r] < max_len`` on most rows,
and the floor under small launches: an empty
kernel (``kernels/empty/csrc/empty.cu``) and ``torch.Tensor.copy_`` of
#1's, #2's and #3's byte counts, under the same timing; the
read-flushed times are extra numbers.

Phase 4 also holds ``flash_attention_bhsd`` against its plain version on
each of its paths, and reports the path each case took
(``path_launches``): f32 prefill (CUDA cores) at the prefill shape, a
non-causal shape, ``Sq = Sk = 37`` and head dims 32 and 16; the
split-KV decode (``Sq = 1``) over cache views of 1, 256 and 1,000 keys
(f32, CUDA cores), and in bf16 on tensor cores over 2,000 keys (d_head
128), Qwen3-30B-A3B's decode (GQA group 8, 1,024 keys), group 8 over
1 and 777 keys and at batch 1 over 8,192; bf16 prefill on tensor cores
(``wgmma`` + TMA, one warpgroup a block) at InternLM2-1.8B's and
Qwen3-30B-A3B's attention (group 8, q [8, 32, 1024, 128]), group 8 at
``Sq = Sk = 200`` and 1,000, non-causal, with q as ``attention()`` passes it (a
``transpose(1, 2)`` view), and head dims 32 and 16; ``Sq = 256, Sk =
128`` causal in both types and ``Sq = 256, Sk = 100`` at group 8 (rows
with no key exactly 0). Each case must take the path its row names, and
is timed beside its plain version and ``scaled_dot_product_attention``;
a bf16 decode over 1,024 keys or more gets 7 medians of each, in turns,
and is "faster" than SDPA only if every one of its medians is below
every one of SDPA's.

The launch count of each kernel is set to 0 before each path (phases 5,
6, 7, 8, 9, 10, 11, 12 (b) and (c), 13 (b)-(f), 14 (c), 15 (d)) and read
after it; every kernel of a path must have launched. The ``kernels`` line
carries the backward kernel too (no Pallas counterpart: the reference
differentiates ``chunked_attention`` under XLA), its launches (calls)
and ``cuda_launches`` those of phase 14 (c).

Every phase raises on failure. The script prints a ``{"kernels": ...}``
JSON line, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. It exits non-zero without a result
when CUDA is unavailable or the package is missing.

Usage: ``python3 chip_smoke.py [--pages N] [--json-out PATH]``
"""
from __future__ import annotations

import argparse
import cProfile
import ctypes
import filecmp
import functools
import gc
import glob
import importlib
import json
import os
import pstats
import re
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
from repro_torch.core.warc import WARCIOArchiveIterator  # noqa: E402
from repro_torch.data.synth import (  # noqa: E402
    CorpusSpec, generate_warc, records_in, write_corpus)
from repro_torch.index import (  # noqa: E402
    CdxIndex, HeaderFilter, IndexQueryService, QueryEngine, QueryRequest,
    RandomAccessReader, build_index, full_scan_regex, full_scan_search)
from repro_torch.core.parallel import map_shards  # noqa: E402
from repro_torch.core.reaper import SHM_PREFIX  # noqa: E402
from repro_torch.core.warc.checksum import (  # noqa: E402
    block_digest, verify_digest, verify_digests_bulk)
from repro_torch.index import verify_index  # noqa: E402
from repro_torch.index.cdx import _index_shard  # noqa: E402
from repro_torch.index.signature import (  # noqa: E402
    SIG_BITS, SIG_HASHES, SIG_NGRAM, signature_of)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.adler32 import adler32_batch  # noqa: E402
from repro_torch.kernels.digest_sig import digest_sig as ds  # noqa: E402
from repro_torch.kernels.digest_sig import digest_signature_rowgroup  # noqa: E402
from repro_torch.kernels.digest_sig.ops import pack_batch  # noqa: E402
from repro_torch.kernels.pattern_scan import pattern_scan as ps  # noqa: E402
from repro_torch.kernels.pattern_scan import (  # noqa: E402
    find_pattern_mask_rowgroup, find_pattern_masks_multi,
    find_pattern_masks_multi_rowgroup)
from repro_torch.obs import trace  # noqa: E402
from repro_torch.obs.export import render_stage_table  # noqa: E402
from repro_torch.serve import ArchiveGateway, Request, ServeEngine  # noqa: E402
from repro_torch.testing.faults import arm_worker_kill, corrupt_warc  # noqa: E402
from repro_torch.configs import get_spec  # noqa: E402
from repro_torch.core.warc import WarcRecordType  # noqa: E402
from repro_torch.data.tokenizer import BOS_ID, encode  # noqa: E402
from repro_torch.kernels.flash_attention import attention_plain  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.attention import rope_cos_sin  # noqa: E402
from repro_torch.models.common import rmsnorm  # noqa: E402

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
POOL_WORKERS = 4            # phase 12's pool (at most the CPU count)
SLEEP_CYCLES = 4_000_000    # ~2 ms of device spin ahead of each timed call
FLASH_DECODE_ROUNDS = 7     # medians of a long bf16 decode and of SDPA
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


def time_ms_read_flush(fn, reps: int = 25) -> float:
    """``time_ms`` with the L2 flushed by reading the flush buffer (a
    reduction over it) instead of zeroing it: the cache then holds clean
    lines, so no write-back of dirty ones lands inside the timed call.
    An extra number beside ``time_ms``'s, never in its place."""
    time_ms(fn, 1)  # allocates the flush buffer, warms fn up
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        _FLUSH.max()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


@functools.cache
def _empty_entry():
    fn = _build.library("empty").empty_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def empty_launch() -> None:
    """One launch of ``kernels/empty/csrc/empty.cu``'s empty kernel."""
    err = _empty_entry()(torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def floor_numbers(nbytes: dict) -> dict:
    """The floor under small launches: an empty kernel's time under
    ``time_ms`` (and, as an extra number, under the read flush), and
    ``torch.Tensor.copy_`` moving each named kernel's byte count (half
    read, half written) as a streaming yardstick, with its byte bound."""
    out = {"empty_kernel_ms": time_ms(empty_launch),
           "empty_kernel_ms_read_flush": time_ms_read_flush(empty_launch),
           "copy": {}}
    for name, nb in nbytes.items():
        src = torch.empty(nb // 2, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        moved = 2 * src.numel()
        out["copy"][name] = {
            "bytes_moved": moved, "ms": time_ms(lambda: dst.copy_(src)),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}
        del src, dst
    log(f"[kernels] floor: empty kernel {out['empty_kernel_ms']:.4g} ms "
        f"(L2 flushed by zeroing), {out['empty_kernel_ms_read_flush']:.4g} "
        f"ms (flushed by reading); copy_ of "
        + "; ".join(f"{k}'s {c['bytes_moved']} bytes {c['ms']:.4g} ms "
                    f"(bound {c['bound_ms']:.4g})"
                    for k, c in out["copy"].items()))
    return out


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


def worst_case_inputs(rows: int, width: int, tail: int = PAD
                      ) -> list[tuple[np.ndarray, np.ndarray]]:
    """(rows, W + tail) matrices on which the early-exit scans never exit
    early: every byte ``a`` with the pattern ``a`` x 16, and text made of
    phase 8's 16-byte pattern repeated (each chunk holds a whole match)."""
    pat = np.frombuffer(b"nginx/1.25\r\nDate", np.uint8)
    same = np.zeros((rows, width + tail), np.uint8)
    same[:, :width] = ord("a")
    rep = np.zeros((rows, width + tail), np.uint8)
    rep[:, :width] = np.resize(pat, width)
    return [(same, np.full(16, ord("a"), np.uint8)), (rep, pat.copy())]


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
    # the early exit never fires: every byte of the pattern matches
    for m, p in worst_case_inputs(675, 12288):
        x = torch.from_numpy(m).cuda()
        for plen in (1, 7, 16):
            got = ps.pattern_scan_rowgroup(x, p, plen)
            want = ps.pattern_scan_rowgroup_plain(x, p, plen)
            torch.cuda.synchronize()
            if not torch.equal(got, want) or not int(want.sum()):
                raise RuntimeError(f"pattern_scan_rowgroup worst case "
                                   f"{bytes(p)!r} P={plen}: card != plain")
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
    # the general body: n-grams past 17 bytes, a sub-block past 2048
    for rows, width, n, kblock in ((6, 8192, 24, 2048), (6, 8192, 129, 2048),
                                   (3, 8192, 4, 4096)):
        x = digest_inputs(rng, rows, width)
        got = ds.digest_sig_partials_batch(x, n=n, block=kblock)
        want = ds.digest_sig_plain(x, n=n, block=kblock)
        torch.cuda.synchronize()
        d = max(int((g.long() - w.long()).abs().max())
                for g, w in zip(got, want))
        err["digest_sig"] = max(err["digest_sig"], d)
        if d:
            raise RuntimeError(f"digest_sig B={rows} W={width} n={n} "
                               f"block={kblock}: max |kernel - plain| = {d}")
    results["max_abs_err"] = err
    log(f"[kernels] every kernel output bit-identical to its plain version "
        f"(max |kernel - plain| = {err}); digest_sig's general body at "
        f"n = 24, 129 and block 4096")


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


def short_lens(lens: torch.Tensor) -> torch.Tensor:
    """``lens`` with three rows in four cut to at most 2, and, where the
    rows allow, lengths 0, -3 and 40 (outside [1, 16]) on rows 1-3."""
    out = lens.clone()
    cut = out.shape[0] - out.shape[0] // 4
    out[:cut] = torch.clamp(out[:cut], max=2)
    for r, v in zip(range(1, out.shape[0]), (0, -3, 40)):
        out[r] = v
    return out


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
              ((1, 1, 256), (3, 2, 1536), (1, 1, 12288), (2048, 2000, 256),
               (1024, 1000, 2048), (675, 675, 12288))))
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
            # the per-row loop bound: lens[r] < max_len on most rows, and
            # lengths outside [1, max_len]
            short = short_lens(n)
            if not torch.equal(kernel(x, p, short, 16),
                               plain(x, p, short, 16)):
                raise RuntimeError(f"{name} B={rows} W={width}: card != "
                                   f"plain with lens[r] < max_len")
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


# label, B, H, Hkv, Sq, Sk, D, dtype, causal, the path the C entry point
# must take (flash_attention.PATHS); "decode" cases read k/v as
# views of a [B, Hkv, S, D] cache (S: Sk rounded up to a multiple of
# 1,024), as decode_step does; "fully masked rows" cases have rows with no key; a
# "q^T" case passes q as attention() does, a transpose(1, 2) view of
# [B, Sq, H, D]
FLASH_CASES = (
    ("prefill", 8, 12, 4, 1024, 1024, 64, torch.float32, True, "prefill_cc"),
    ("decode Sk=1", 8, 12, 4, 1, 1, 64, torch.float32, True, "decode"),
    ("decode Sk=256", 8, 12, 4, 1, 256, 64, torch.float32, True, "decode"),
    ("decode Sk=1000", 8, 12, 4, 1, 1000, 64, torch.float32, True, "decode"),
    ("decode bf16 Sk=2000", 8, 16, 8, 1, 2000, 128, torch.bfloat16,
     True, "decode_tc"),
    ("internlm2-1.8b bf16", 1, 16, 8, 2048, 2048, 128, torch.bfloat16,
     True, "prefill_tc"),
    ("qwen3-moe bf16 prefill", 8, 32, 4, 1024, 1024, 128, torch.bfloat16,
     True, "prefill_tc"),
    ("decode qwen3-moe bf16 Sk=1024", 8, 32, 4, 1, 1024, 128, torch.bfloat16,
     True, "decode_tc"),
    ("non-causal", 2, 12, 4, 512, 700, 64, torch.float32, False, "prefill_cc"),
    ("fully masked rows", 1, 4, 2, 256, 128, 64, torch.float32,
     True, "prefill_cc"),
    ("fully masked rows bf16", 1, 4, 2, 256, 128, 64, torch.bfloat16,
     True, "prefill_tc"),
    ("ragged 37", 2, 12, 4, 37, 37, 64, torch.float32, True, "prefill_cc"),
    ("d32", 8, 4, 2, 512, 512, 32, torch.float32, True, "prefill_cc"),
    ("d32 bf16", 8, 4, 2, 512, 512, 32, torch.bfloat16, True, "prefill_tc"),
    ("d16", 8, 4, 2, 512, 512, 16, torch.float32, True, "prefill_cc"),
    ("d16 bf16", 8, 4, 2, 512, 512, 16, torch.bfloat16, True, "prefill_tc"),
    # GQA group 8 at D = 128 (Qwen3-30B-A3B's attention), ragged
    ("decode group 8 bf16 Sk=1", 8, 32, 4, 1, 1, 128, torch.bfloat16,
     True, "decode_tc"),
    ("decode group 8 bf16 Sk=777", 2, 32, 4, 1, 777, 128, torch.bfloat16,
     True, "decode_tc"),
    # batch 1 over a long cache: 4 pairs, the bf16 decode's most splits
    ("decode qwen3-moe batch 1 bf16 Sk=8192", 1, 32, 4, 1, 8192, 128,
     torch.bfloat16, True, "decode_tc"),
    ("group 8 bf16 Sq=Sk=200", 1, 16, 2, 200, 200, 128, torch.bfloat16,
     True, "prefill_tc"),
    ("group 8 bf16 Sq=Sk=1000", 1, 16, 2, 1000, 1000, 128, torch.bfloat16,
     True, "prefill_tc"),
    ("fully masked rows group 8 bf16", 1, 16, 2, 256, 100, 128, torch.bfloat16,
     True, "prefill_tc"),
    ("group 8 bf16 non-causal", 1, 16, 2, 200, 150, 128, torch.bfloat16,
     False, "prefill_tc"),
    ("group 8 bf16 q^T", 2, 16, 2, 200, 200, 128, torch.bfloat16,
     True, "prefill_tc"),
)


def flash_checks(results: dict) -> None:
    """flash_attention_bhsd on the card against its plain version (rtol
    1e-4 / atol 1e-5 in f32, 2e-2 in bf16: the reference's kernel-test
    tolerances) at each case, timed beside the plain version and
    ``scaled_dot_product_attention``: ``is_causal`` where Sq == Sk;
    decode is SDPA non-causal over the valid prefix, the same function;
    a causal case with Sq != Sk passes the bottom-right mask as
    ``attn_mask`` (SDPA's own causal mask is top-left aligned), its error
    taken on the rows that have keys. Each case synchronises before its
    check, so a fault stops the run where it happened."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    err = {"float32": 0.0, "bfloat16": 0.0}
    out = {}
    for label, b, h, hkv, sq, sk, d, dt, causal, want_path in FLASH_CASES:
        if label.endswith("q^T"):
            q = torch.randn((b, sq, h, d), generator=gen,
                            device="cuda").to(dt).transpose(1, 2)
        else:
            q = torch.randn((b, h, sq, d), generator=gen,
                            device="cuda").to(dt)
        if label.startswith("decode"):
            cache = torch.randn((2, b, hkv, -(-sk // 1024) * 1024, d),
                                generator=gen, device="cuda").to(dt)
            k, v = cache[0, :, :, :sk], cache[1, :, :, :sk]
        else:
            k, v = (torch.randn((b, hkv, sk, d), generator=gen,
                                device="cuda").to(dt) for _ in range(2))
        before = dict(fa.path_launches)
        got = fa.flash_attention_bhsd(q, k, v, causal=causal)
        path = next(p for p in fa.PATHS if fa.path_launches[p] > before[p])
        if path != want_path:
            raise RuntimeError(f"flash_attention {label}: took {path}, not "
                               f"{want_path}")
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
        if label.startswith("fully masked rows") and (
                got[:, :, :sq - sk].abs().max() != 0
                or got[:, :, sq - sk:].abs().min() == 0):
            raise RuntimeError(f"flash_attention {label}: rows with no key "
                               f"!= 0")
        ms = time_ms(lambda: fa.flash_attention_bhsd(q, k, v, causal=causal))
        pms = time_ms(lambda: attention_plain(q, k, v, causal=causal), 20)
        mask = None
        if causal and sq != sk and sq > 1:
            mask = torch.ones((sq, sk), dtype=torch.bool,
                              device="cuda").tril(sk - sq)

        def sdpa():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask,
                is_causal=causal and sq == sk and sq > 1, enable_gqa=True)
        lib = time_ms(sdpa)
        lib_err = float((torch.nan_to_num(sdpa().float()) - want.float())
                        .abs().max())
        nbytes, ops = flash_cost(b, h, hkv, sq, sk, d, q.element_size(),
                                 causal)
        bnd, by = flash_bound(nbytes, ops, dt)
        rounds = {}
        if dt == torch.bfloat16 and sq == 1 and sk >= 1024:
            # a bf16 decode against SDPA: more medians, kernel and SDPA in
            # turns; "faster" only if every kernel median beats every SDPA
            # median
            rounds = {"ms_rounds": [ms], "library_ms_rounds": [lib]}
            for _ in range(FLASH_DECODE_ROUNDS - 1):
                rounds["ms_rounds"].append(time_ms(
                    lambda: fa.flash_attention_bhsd(q, k, v, causal=causal)))
                rounds["library_ms_rounds"].append(time_ms(sdpa))
            rounds["faster_than_library"] = (
                max(rounds["ms_rounds"]) < min(rounds["library_ms_rounds"]))
            log(f"[kernels] flash_attention {label}: {FLASH_DECODE_ROUNDS} "
                f"medians, kernel {min(rounds['ms_rounds']):.5g}-"
                f"{max(rounds['ms_rounds']):.5g} ms, SDPA "
                f"{min(rounds['library_ms_rounds']):.5g}-"
                f"{max(rounds['library_ms_rounds']):.5g} ms: "
                + ("faster in every round" if rounds["faster_than_library"]
                   else "not faster in every round"))
        out[label] = {"shape_q": [b, h, sq, d], "shape_kv": [b, hkv, sk, d],
                      "dtype": str(dt), "causal": causal, "path": path,
                      "max_abs_err": e,
                      "ms": ms, "plain_ms": pms, "library_ms": lib,
                      "library_max_abs_err": lib_err, "bound_ms": bnd,
                      "bound_by": by, "bytes": nbytes, "flops": ops,
                      **rounds}
        log(f"[kernels] flash_attention {label} q{[b, h, sq, d]} "
            f"kv{[b, hkv, sk, d]} {str(dt)[6:]} causal={causal} ({path}): "
            f"{ms:.4g} "
            f"ms/launch, bound {bnd:.4g} ms ({by}), plain {pms:.4g} ms, "
            f"SDPA {lib:.4g} ms; max |kernel - plain| = {e:.3g}, "
            f"|SDPA - plain| = {lib_err:.3g}")
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


class CallSpy:
    """Counts the calls of a wrapper of ``repro_torch.kernels.pattern_scan``
    while a phase runs (the engine and the gateway import it from the
    package at each call) and keeps the arguments of the call with the
    most width buckets, the most bytes among equals: a real call's
    buckets, to time as one grouped launch."""

    def __init__(self, name: str) -> None:
        self.pkg = importlib.import_module("repro_torch.kernels.pattern_scan")
        self.name = name
        self.fn = getattr(self.pkg, name)
        self.calls = 0
        self.key: tuple = ()
        self.best: tuple | None = None
        self.lock = threading.Lock()

    def __enter__(self) -> "CallSpy":
        from repro_torch.kernels.bucketing import dispatch_count

        def spy(bufs, *args, **kw):
            bufs = list(bufs)
            sizes = [len(b) for b in bufs]
            key = (dispatch_count(sizes, kw["block"]), sum(sizes))
            with self.lock:
                self.calls += 1
                if key > self.key:
                    self.key, self.best = key, (bufs, args, kw["block"])
            return self.fn(bufs, *args, **kw)

        setattr(self.pkg, self.name, spy)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.pkg, self.name, self.fn)


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
             for k in ("pack", "h2d", "kernel", "d2h", "fold")}
    results["build"] = {"records": len(index), "seconds": dt,
                        "records_per_s": len(index) / dt, "stages_s": stage,
                        "digest_sig_split_s": split}
    log(f"[build] {len(index)} records in {dt:.3f} s = "
        f"{len(index) / dt:.1f} records/s; stages (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
        + "; digest_sig split (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    results["digest_sig_shape"] = dominant_shape("digest_signature_batch")
    log(f"[build] {ds.launches} digest_sig launches for "
        f"{int(c['kernel.digest_signature_batch.dispatches'])} width buckets")
    results["flush_group"] = first_flush(paths[0])

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


def first_flush(path: str) -> tuple[torch.Tensor, np.ndarray, int]:
    """The build's first flush of ``path`` (its first records, up to the
    build's flush limits) packed as the batch wrapper packs it: the
    pinned staging buffer, its descriptor table and output words."""
    from repro_torch.index.cdx import _FUSED_BATCH, _FUSED_BATCH_BYTES

    bufs, nbytes = [], 0
    for rec in FastWARCIterator(path, parse_http=False):
        bufs.append(np.frombuffer(rec.content, np.uint8))
        nbytes += bufs[-1].size
        if len(bufs) >= _FUSED_BATCH or nbytes >= _FUSED_BATCH_BYTES:
            break
    staging, table, words, _ = pack_batch(bufs, pin=True)
    return staging, table, words


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
    with CallSpy("find_pattern_mask_batch") as spy, \
            IndexQueryService(index, device="cuda") as svc:
        responses = svc.serve(reqs)
        stats = dict(svc.engine.stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    results["pattern_scan_launches"] = ps.launches
    results["pattern_scan_shape"] = dominant_shape("find_pattern_mask_batch")
    results["scan_call"] = spy.best
    c = obs.snapshot().counters
    split = {k: c.get(f"stage.find_pattern_mask_batch.{k}_us", 0) / 1e6
             for k in ("pack", "h2d", "kernel", "d2h")}
    buckets = int(c.get("kernel.find_pattern_mask_batch.dispatches", 0))
    log(f"[serve] {ps.launches} pattern_scan_batch launches for {spy.calls} "
        f"kernel-path scan batches ({buckets} width buckets; the engine's "
        f"{stats['batches']} batches include host-path ones)")
    if ps.launches != spy.calls or not spy.calls:
        raise RuntimeError(f"{ps.launches} pattern_scan_batch launches for "
                           f"{spy.calls} find_pattern_mask_batch calls")
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
                        "scan_split_s": split, "broad_share": share,
                        "kernel_path_batches": spy.calls,
                        "width_buckets": buckets,
                        "pattern_scan_launches": ps.launches}
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
                 for k in ("pack", "h2d", "kernel", "d2h", "fold")}
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


# -- phase 12 --------------------------------------------------------------
def index_or_die(path: str) -> CdxIndex:
    """Phase 12 (d)'s supervised sweep (module-level: pool workers run
    it): one shard on the host path; a shard the parser cannot read
    kills its worker, as a shard that crashes its process would."""
    try:
        return _index_shard(path, sig_bits=SIG_BITS, sig_ngram=SIG_NGRAM,
                            sig_hashes=SIG_HASHES, fused=False, device="cpu")
    except Exception:
        os._exit(77)


def same_index(got: CdxIndex, want: CdxIndex, label: str) -> None:
    for name in CDX_COLUMNS:
        if not np.array_equal(getattr(got, name), getattr(want, name)):
            raise RuntimeError(f"{label}: column {name} != phase 5's")
    if (got.uri_heap, got.mime_heap, got.shard_paths) != (
            want.uri_heap, want.mime_heap, want.shard_paths):
        raise RuntimeError(f"{label}: heaps or shard paths != phase 5's")


def pool_stats(snap, records: int | None = None) -> dict:
    """The pool's transport and supervisor counters of a merged snapshot;
    with ``records``, also checks that the workers' ``index.records``
    arrived once each (none lost, none counted twice)."""
    c = snap.counters
    if records is not None and c.get("index.records") != records:
        raise RuntimeError(f"pool: index.records {c.get('index.records')} "
                           f"in the merged snapshot, {records} records")
    return {"transport": "shm" if snap.gauge("pool.transport.shm") else
            "pickle",
            "transport_stats": {k[len("pool.transport."):]: v
                                for k, v in sorted(c.items())
                                if k.startswith("pool.transport.")},
            "supervisor_stats": {k: c.get(f"pool.{k}", 0) for k in
                                 ("respawns", "quarantined", "hangs")},
            "sources": list(snap.sources)}


def check_spread(snap, workers: int, label: str) -> None:
    """Raise unless every one of ``workers`` pool workers ran a shard
    (published a stats snapshot): the pool deals breadth-first, so the 4
    shards of (a)-(c) go one to each of the 4 workers."""
    slots = {src.split(".")[0] for src in snap.sources
             if src.startswith("worker-")}
    if len(slots) != workers:
        raise RuntimeError(f"pool {label}: {len(slots)} of {workers} "
                           f"workers ran a shard ({sorted(snap.sources)})")


def worker_stages(snap) -> dict:
    """Seconds of the workers' ``index.stage.*`` and ``stage.
    digest_signature_batch.*`` counters, summed over the workers (they
    reach this process through the workers' stats slots)."""
    c = snap.counters
    out = {k: c.get(f"index.stage.{k}_us", 0) / 1e6
           for k in ("parse", "digest_sig", "assemble")}
    out.update({f"digest_sig.{k}": c.get(
        f"stage.digest_signature_batch.{k}_us", 0) / 1e6
        for k in ("pack", "h2d", "kernel", "d2h", "fold")})
    return {k: v for k, v in out.items() if v}


def pool_phase(paths: list[str], workdir: Path, index: CdxIndex,
               results: dict) -> None:
    """Phase 12: build and derive through the process pool."""
    cpus = os.cpu_count() or 1
    w = min(POOL_WORKERS, cpus)
    n = len(index)
    out: dict = {"workers": w, "cpu_count": cpus}
    log(f"[pool] W = {w} workers, os.cpu_count() = {cpus}; map_shards "
        f"sends each shard's result through its worker's pipe (transport "
        f"pickle, no ring segments)")

    # (a) the host path in the workers, asked for
    obs.reset()
    t0 = time.perf_counter()
    idx_a = build_index(paths, workers=w, fused=False, device="cuda")
    dt = time.perf_counter() - t0
    same_index(idx_a, index, "pool (a)")
    check_spread(idx_a.obs, min(w, len(paths)), "(a)")
    out["host_build"] = {"seconds": dt, "records_per_s": n / dt,
                         "worker_stages_s": worker_stages(idx_a.obs),
                         **pool_stats(idx_a.obs, n)}
    log(f"[pool] (a) build_index(workers={w}, fused=False), host path in "
        f"the workers: "
        f"{dt:.3f} s = {n / dt:.1f} records/s (phase 5, serial on the "
        f"card: {results['build']['records_per_s']:.1f}); columns == "
        f"phase 5's; worker stages summed (s): "
        f"{worker_stages(idx_a.obs)}; {pool_stats(idx_a.obs)}")

    # (b) the default on the card: digest_sig launched inside the workers
    obs.reset()
    ds.launches = 0
    t0 = time.perf_counter()
    idx_b = build_index(paths, workers=w, device="cuda")
    dt = time.perf_counter() - t0
    same_index(idx_b, index, "pool (b)")
    check_spread(idx_b.obs, min(w, len(paths)), "(b)")
    launches = idx_b.obs.counter("kernel.digest_sig.launches")
    buckets = idx_b.obs.counter("kernel.digest_signature_batch.dispatches")
    if ds.launches or launches != results["digest_sig_launches"]:
        raise RuntimeError(
            f"pool (b): {launches} digest_sig launches in the workers and "
            f"{ds.launches} in this process; phase 5 made "
            f"{results['digest_sig_launches']}")
    results["pool_digest_sig_launches"] = launches
    out["fused_build"] = {"seconds": dt, "records_per_s": n / dt,
                          "digest_sig_launches": launches,
                          "width_buckets": buckets,
                          "worker_stages_s": worker_stages(idx_b.obs),
                          **pool_stats(idx_b.obs, n)}
    log(f"[pool] (b) build_index(workers={w}) (default: digest_sig in the "
        f"workers): {dt:.3f} s = "
        f"{n / dt:.1f} records/s; columns == phase 5's; {launches} "
        f"digest_sig launches in the workers (kernel.digest_sig.launches "
        f"via their stats slots; phase 5: {results['digest_sig_launches']}), "
        f"{buckets} width buckets; worker stages summed (s): "
        f"{worker_stages(idx_b.obs)}; {pool_stats(idx_b.obs)}")

    # (c) derive: the workers parse, this process launches digest_sig
    out2 = workdir / "pool.repcol"
    obs.reset()
    ds.launches = 0
    t0 = time.perf_counter()
    store2 = derive(paths, str(out2), workers=w, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    results["pool_derive_digest_sig_launches"] = ds.launches
    snap = store2.obs
    c = obs.snapshot().counters
    stage = {k: c.get(f"derive.stage.{k}_us", 0) / 1e6
             for k in ("parse", "digest_sig", "pack_write")}
    store2.close()
    check_spread(snap, min(w, len(paths)), "(c)")
    if not filecmp.cmp(out2, workdir / "corpus.repcol", shallow=False):
        raise RuntimeError("pool (c): the .repcol file != phase 7's")
    out["derive"] = {"seconds": dt, "records_per_s": n / dt,
                     "digest_sig_launches": ds.launches, "stages_s": stage,
                     **pool_stats(snap)}
    log(f"[pool] (c) derive(workers={w}): {dt:.3f} s = {n / dt:.1f} "
        f"records/s (phase 7: {results['derive']['records_per_s']:.1f}); "
        f".repcol byte-identical to phase 7's ({out2.stat().st_size} "
        f"bytes); {ds.launches} digest_sig launches here; stages (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
        + f"; {pool_stats(snap)}")
    out2.unlink()

    # (d) supervision: one injected worker death (the digest kernel in
    # the workers, so the replacement opens a CUDA context of its own),
    # then a poison shard. Two workers: one of them takes a 2nd shard
    obs.reset()
    t0 = time.perf_counter()
    with arm_worker_kill(workdir, nth=2) as latch:
        idx_d = build_index(paths, workers=2, supervise=True, device="cuda")
        fired = os.path.exists(latch)
    dt = time.perf_counter() - t0
    same_index(idx_d, index, "pool (d) kill")
    st = pool_stats(idx_d.obs, n)
    if not fired or st["supervisor_stats"]["respawns"] != 1:
        raise RuntimeError(f"pool (d): kill fired {fired}, "
                           f"{st['supervisor_stats']}")
    out["kill"] = {"seconds": dt, **st}
    log(f"[pool] (d) supervised build_index(workers=2) (digest_sig in the "
        f"workers) with a "
        f"worker killed before its 2nd result: 1 respawn, columns == phase "
        f"5's, {dt:.3f} s; {st}")
    poison = workdir / "poison.warc.gz"
    poison.write_bytes(b"\x1f\x8b\x08" + bytes(64))
    obs.reset()
    t0 = time.perf_counter()
    parts, snap = map_shards(index_or_die, [*paths, str(poison)],
                             workers=w, supervise=True, poison_kills=2,
                             with_obs=True)
    dt = time.perf_counter() - t0
    st = pool_stats(snap, n)
    if parts[-1] is not None or st["supervisor_stats"]["quarantined"] != 1:
        raise RuntimeError(f"pool (d): the poison shard was not "
                           f"quarantined: {st}")
    same_index(CdxIndex.merge(parts[:-1]), index, "pool (d) poison")
    out["poison"] = {"seconds": dt, **st}
    log(f"[pool] (d) map_shards(supervise=True, poison_kills=2) over the "
        f"4 shards and a garbage one: the garbage shard quarantined, the "
        f"other four partials == phase 5's index, {dt:.3f} s; {st}")
    left = glob.glob(f"/dev/shm/{SHM_PREFIX}-*")
    if left:
        raise RuntimeError(f"pool: shared-memory segments left: {left}")
    out["shm_left"] = 0
    results["pool"] = out
    log(f"[pool] /dev/shm/{SHM_PREFIX}-* segments left afterwards: none")


def stop_mp_helpers() -> None:
    """Stop and reap the helper processes ``multiprocessing`` started
    for this run: the forkserver (phase 12's pools) and the resource
    tracker (the corpus's spawn pool, the pools' semaphores). Left to
    themselves they exit only after this script does, as orphans that
    the chip machine's PID 1 does not reap. A later pool or semaphore
    starts them again."""
    from multiprocessing import forkserver, resource_tracker

    gc.collect()  # finalize dead semaphores while the tracker still runs
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


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
    with CallSpy("find_pattern_masks_multi") as spy, \
            ArchiveGateway(index, shards=GW_SHARDS, device="cuda") as gw:
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
             for k in ("pack", "h2d", "kernel", "d2h")}
    results["gateway_shape"] = dominant_shape("find_pattern_masks_multi")
    results["gateway_chunk"] = spy.best
    spans = snap.get("stages", {}).get("kernel_dispatch", {}).get("count")
    keep = ("requests", "responses", "coalesced", "unique_scans",
            "scan_batches", "kernel_dispatches", "dispatches_per_request",
            "records_scanned", "records_fetched", "host_scans",
            "latency_p50_ms", "latency_p99_ms", "cache_hit_rate", "errors")
    results["gateway"] = {
        "submissions": want, "seconds": dt, "requests_per_s": want / dt,
        "metrics": {k: snap[k] for k in keep},
        "stages": snap.get("stages", {}), "scan_split_s": split,
        "multi_launches": ps.multi_launches,
        "find_pattern_masks_multi_calls": spy.calls,
        "kernel_dispatch_spans": spans}
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
    log(f"[gateway] {ps.multi_launches} pattern_scan_batch_multi launches "
        f"for {spy.calls} find_pattern_masks_multi calls and {spans} "
        f"gw.kernel_dispatch spans ({snap['kernel_dispatches']} width "
        f"buckets, {snap['scan_batches']} drain batches)")
    if not ps.multi_launches == spy.calls == (
            spy.calls if spans is None else spans):
        raise RuntimeError(f"{ps.multi_launches} pattern_scan_batch_multi "
                           f"launches for {spy.calls} calls, {spans} spans")


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


def decode_profile(params, cfg, batch: int, seq: int, length: int,
                   n_steps: int = 16) -> dict:
    """Device time of the engine's decode steps: ``n_steps``
    ``decode_step`` calls on a batch-``batch`` cache holding ``length``
    positions, timed on the host clock, then again under
    ``torch.profiler`` for the device time by kernel; busy share = device
    time / unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    def steps(cache, tok):
        for _ in range(n_steps):
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
    by_kernel = kernel_times(prof)
    device = sum(by_kernel.values())
    flash = sum(t for k, t in by_kernel.items()
                if "flash_fwd" in k or "flash_decode" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"steps": n_steps, "cache_length": length, "wall_s": wall,
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
    results["lm"]["reduced"] = reduced_lm_check(payloads)
    results["lm"]["phase_s"] = time.perf_counter() - t_phase
    log(f"[lm] phase 11 in {results['lm']['phase_s']:.3f} s")


def reduced_lm_check(payloads: list[bytes]) -> dict:
    """(c) The reduced fastwarc_lm as its spec defines it (d_head 32) on
    the card: forward over 2 x 77 seeded tokens within rtol/atol 2e-4 of
    the CPU forward with the same seeded weights, and the engine's greedy
    tokens for 4 corpus prompts equal to the CPU engine's."""
    cfg = get_spec("fastwarc_lm").reduced
    gpu = tf.init_params(cfg, generator=torch.Generator().manual_seed(SEED))
    cpu = tf.init_params(cfg, generator=torch.Generator().manual_seed(SEED),
                         device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(SEED + 12).integers(
        0, cfg.vocab, (2, 77)))
    before = fa.launches
    with torch.inference_mode():
        got, _ = tf.forward(gpu, tokens.cuda(), cfg)
        torch.cuda.synchronize()
        want, _ = tf.forward(cpu, tokens, cfg)
    diff = float((got.cpu() - want).abs().max())
    try:
        torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    except AssertionError as exc:
        raise RuntimeError(f"reduced {cfg.name} (d_head {cfg.d_head}): card "
                           f"!= CPU forward: {exc}") from None
    prompts = [p[:48] for p in payloads[:4]]
    outs = []
    for params, dev in ((gpu, "cuda"), (cpu, "cpu")):
        engine = ServeEngine(cfg, params, batch_size=2, max_seq=96,
                             temperature=0.0, device=dev)
        outs.append([r.out_tokens for r in engine.serve(
            [Request(p, max_new_tokens=16) for p in prompts])])
    torch.cuda.synchronize()
    launches = fa.launches - before
    if outs[0] != outs[1] or launches <= 0:
        raise RuntimeError(f"reduced {cfg.name}: engine tokens card "
                           f"{outs[0]} != CPU {outs[1]} (or no launch: "
                           f"{launches})")
    log(f"[lm] (c) reduced {cfg.name} (d_head {cfg.d_head}, {cfg.n_heads} "
        f"q / {cfg.n_kv_heads} kv heads) on the card: forward [2, 77] == CPU "
        f"forward, max |card - CPU| = {diff:.3g}; greedy tokens of 4 prompts "
        f"== the CPU engine's ({sum(map(len, outs[0]))} tokens); "
        f"{launches} flash_attention launches")
    return {"d_head": cfg.d_head, "max_abs_diff_vs_cpu": diff,
            "engine_tokens": sum(map(len, outs[0])), "launches": launches}


# -- phase 14 --------------------------------------------------------------
# label, B, H, Hkv, Sq, Sk, D, causal: the backward kernel's checks; the
# first is fastwarc_lm's attention at train_1k (batch 32 x 1,024)
BWD_CASES = (
    ("train_1k", 32, 12, 4, 1024, 1024, 64, True),
    ("d16", 8, 4, 2, 512, 512, 16, True),
    ("d32", 8, 4, 2, 512, 512, 32, True),
    ("d128", 2, 8, 2, 512, 512, 128, True),
    ("Sq < Sk", 2, 12, 4, 300, 700, 64, True),
    ("rows with no key", 1, 4, 2, 256, 128, 64, True),
    ("non-causal", 2, 12, 4, 256, 384, 64, False),
)
BWD_TOL = 1e-4      # rtol and atol of dq/dk/dv, lse and out against plain
PREFILL_F32_MS = (0.5276, 0.5340)  # phase 4's f32 prefill, PRs 16-22
# phase 14 (a) fails when phase 4's f32 prefill falls outside the range
# widened by this on each side: twice the range's own width, the spread
# of seven readings on seven machines (H100 80GB HBM3, 700 W)
PREFILL_F32_MARGIN_MS = 2 * (PREFILL_F32_MS[1] - PREFILL_F32_MS[0])


def bwd_cost(b: int, h: int, hkv: int, sq: int, sk: int, d: int,
             causal: bool) -> tuple[int, int]:
    """The backward's least work: read q, k, v, o, dO, lse once, write
    dq, dk, dv (f32); 2 flops per multiply-add of the five products
    (Q K^T, dO V^T, P^T dO, dS^T Q, dS K) over the pairs the mask keeps."""
    i = np.arange(sq, dtype=np.int64)
    pairs = (int(np.clip(i + sk - sq + 1, 0, sk).sum()) if causal
             else sq * sk)
    q_elems, kv_elems = b * h * sq * d, b * hkv * sk * d
    nbytes = 4 * (4 * q_elems + 4 * kv_elems + b * h * sq)
    return nbytes, 10 * b * h * d * pairs


def attention_grad_checks(results: dict) -> None:
    """(a) The backward kernel (``flash_attention_backward``, with the
    forward's lse path ``flash_attention_fwd_lse``) against
    ``attention_backward_plain`` on the card at each of ``BWD_CASES``,
    within rtol/atol ``BWD_TOL``; each timed (L2 flushed) beside its
    plain version and, at the training shape, the backward of
    ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``.
    Then phase 4's f32 prefill time against its recorded range."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        attention_backward_plain, flash_attention_backward)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    out, worst = {}, 0.0
    for label, b, h, hkv, sq, sk, d, causal in BWD_CASES:
        q = torch.randn((b, h, sq, d), generator=gen, device="cuda")
        k, v = (torch.randn((b, hkv, sk, d), generator=gen, device="cuda")
                for _ in range(2))
        do = torch.randn((b, h, sq, d), generator=gen, device="cuda")
        o, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
        o_p, lse_p = attention_plain(q, k, v, causal=causal, return_lse=True)
        got = flash_attention_backward(q, k, v, o, lse, do, causal=causal)
        want = attention_backward_plain(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        errs = {"out": float((o - o_p).abs().max()),
                "lse": float((lse - lse_p).abs().max())}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            errs[name] = float((g - w).abs().max())
            try:
                torch.testing.assert_close(g, w, rtol=BWD_TOL, atol=BWD_TOL)
            except AssertionError as exc:
                raise RuntimeError(f"attention backward {label}: {name} "
                                   f"card != plain: {exc}") from None
        try:
            torch.testing.assert_close(o, o_p, rtol=BWD_TOL, atol=1e-5)
            torch.testing.assert_close(lse, lse_p, rtol=BWD_TOL,
                                       atol=BWD_TOL)
        except AssertionError as exc:
            raise RuntimeError(f"attention forward (lse) {label}: card != "
                               f"plain: {exc}") from None
        if label == "rows with no key" and (
                got[0][:, :, :sq - sk].abs().max() != 0
                or lse[:, :, :sq - sk].min() != 1e30):
            raise RuntimeError("attention backward: a row with no key has "
                               "a gradient or a finite lse")
        grad_err = max(errs["dq"], errs["dk"], errs["dv"])
        worst = max(worst, grad_err)
        ms = time_ms(lambda: flash_attention_backward(
            q, k, v, o, lse, do, causal=causal))
        fwd_ms = time_ms(lambda: fa.flash_attention_fwd_lse(
            q, k, v, causal=causal))
        pms = time_ms(lambda: attention_backward_plain(
            q, k, v, o, lse, do, causal), 10)
        nbytes, ops = bwd_cost(b, h, hkv, sq, sk, d, causal)
        bnd, by = flash_bound(nbytes, ops, torch.float32)
        lib = None
        if label == "train_1k":
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
            lo = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                                enable_gqa=True)
            lib = time_ms(lambda: torch.autograd.grad(
                lo, (qg, kg, vg), do, retain_graph=True))
            del qg, kg, vg, lo
        out[label] = {"shape_q": [b, h, sq, d], "shape_kv": [b, hkv, sk, d],
                      "causal": causal, "max_abs_err": errs, "ms": ms,
                      "fwd_lse_ms": fwd_ms, "plain_ms": pms,
                      "library_ms": lib, "bound_ms": bnd, "bound_by": by,
                      "bytes": nbytes, "flops": ops}
        log(f"[train] (a) attention backward {label} q{[b, h, sq, d]} "
            f"kv{[b, hkv, sk, d]} causal={causal}: {ms:.4g} ms/call (3 "
            f"launches), bound {bnd:.4g} ms ({by}), plain {pms:.4g} ms"
            + (f", SDPA backward {lib:.4g} ms" if lib is not None else "")
            + f"; forward with lse {fwd_ms:.4g} ms; max |kernel - plain| "
            + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
            + f" (tolerance rtol = atol = {BWD_TOL:g})")
        del q, k, v, do, o, lse, o_p, lse_p, got, want
        torch.cuda.empty_cache()
    pre = results["flash"]["prefill"]["ms"]
    lo, hi = PREFILL_F32_MS
    gate = (lo - PREFILL_F32_MARGIN_MS, hi + PREFILL_F32_MARGIN_MS)
    inside = lo <= pre <= hi
    results["prefill_f32_check"] = {"ms": pre, "recorded": [lo, hi],
                                    "gate": list(gate), "inside": inside}
    if not gate[0] <= pre <= gate[1]:
        raise RuntimeError(f"phase 4's f32 prefill with the lse parameter: "
                           f"{pre:.4g} ms, outside {gate[0]:.4g}-"
                           f"{gate[1]:.4g} ms (its recorded range {lo}-{hi} "
                           f"ms +- {PREFILL_F32_MARGIN_MS:.4g})")
    log(f"[train] (a) phase 4's f32 prefill with the lse parameter: "
        f"{pre:.4g} ms ({'inside' if inside else 'outside'} its recorded "
        f"range {lo}-{hi} ms; the gate {gate[0]:.4g}-{gate[1]:.4g} ms)")
    results["attention_backward"] = out
    results["max_abs_err"]["flash_attention_backward"] = worst


TRAIN_STEPS = 20            # phase 14 (c): train_lm steps at train_1k ...
TRAIN_CKPT_EVERY = 10       # ... with a checkpoint every this many
STEP_TOL = {"loss": (1e-5, 0.0), "grads": (1e-3, 1e-5), "params": (1e-5, 5e-6)}


def reduced_step_check() -> dict:
    """(b) One training step of the reduced fastwarc_lm (d_head 32, the
    spec's own) on the card against the CPU port, from the same seeded
    parameters and batch (4 x 256 seeded tokens, some labels -1): the
    loss, every gradient leaf and the parameters after the AdamW step
    within ``STEP_TOL`` (rtol, atol; the card's attention is the f32
    kernels, the CPU's the plain version in float64, and the matrix
    products sum in another order). The step's AdamW has eps 1e-3, so
    its update stays linear in the gradient (with 1e-8 the first step
    moves a parameter whose gradient is near 0 by ~lr either way)."""
    from repro_torch.kernels.flash_attention import backward as bwd
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = get_spec("fastwarc_lm").reduced
    rng = np.random.default_rng(SEED + 14)
    tokens = rng.integers(0, cfg.vocab, (4, 257)).astype(np.int32)
    labels = tokens[:, 1:].copy()
    labels[:, :3] = -1
    batch = {"tokens": tokens[:, :-1], "labels": labels}
    out = {}
    f0, b0 = fa.launches, bwd.launches
    for dev in ("cuda", "cpu"):
        state = init_train_state(tf.init_params(
            cfg, generator=torch.Generator().manual_seed(SEED), device=dev))
        names, leaves = zip(*state["params"].named_parameters())
        loss = tf.loss_fn(state["params"], batch["tokens"], batch["labels"],
                          cfg)
        grads = torch.autograd.grad(loss, leaves)
        step = make_train_step(
            lambda p, b: tf.loss_fn(p, b["tokens"], b["labels"], cfg),
            AdamWConfig(warmup_steps=1, eps=1e-3))
        state, _ = step(state, batch)
        out[dev] = {"loss": loss.detach().cpu().reshape(1),
                    "grads": {n: g.cpu() for n, g in zip(names, grads)},
                    "params": {n: p.detach().cpu() for n, p in
                               state["params"].named_parameters()}}
    torch.cuda.synchronize()
    launches = (fa.launches - f0, bwd.launches - b0)
    errs = {}
    for key, (rtol, atol) in STEP_TOL.items():
        got, want = out["cuda"][key], out["cpu"][key]
        if key == "loss":
            got, want = {"loss": got}, {"loss": want}
        errs[key] = max(float((got[n] - want[n]).abs().max()) for n in want)
        for n in want:
            try:
                torch.testing.assert_close(got[n], want[n], rtol=rtol,
                                           atol=atol)
            except AssertionError as exc:
                raise RuntimeError(f"train (b) {key} {n}: card != CPU: "
                                   f"{exc}") from None
    if min(launches) <= 0:
        raise RuntimeError(f"train (b): launches (forward, backward) "
                           f"{launches}")
    log(f"[train] (b) reduced {cfg.name} (d_head {cfg.d_head}), one step "
        f"on [4, 256] tokens: card == CPU (max |card - CPU|: loss "
        f"{errs['loss']:.3g}, gradients {errs['grads']:.3g}, parameters "
        f"after AdamW {errs['params']:.3g}; rtol/atol {STEP_TOL}); "
        f"flash_attention / backward launches {launches}")
    return {"max_abs_err": errs, "tolerance": STEP_TOL,
            "launches": launches}


def train_phase(paths: list[str], workdir: Path, results: dict) -> None:
    """Phase 14: (a) the backward kernel against its plain version; (b)
    the reduced step, card against CPU; (c) ``train_lm`` at full width
    (train_1k: batch 32 x 1,024) on phase 1's corpus for ``TRAIN_STEPS``
    steps with a checkpoint every ``TRAIN_CKPT_EVERY``: the loss falls
    (``train_lm`` returns each step's loss and time); a second
    ``train_lm`` resumed from the step-10 checkpoint gives the same
    losses (rtol 1e-5); the loader restored from that checkpoint's cursor
    gives the uninterrupted loader's batches bit for bit, and a
    ``WarcTokenLoader(workers=2)`` the serial loader's."""
    from repro_torch.data.loader import WarcTokenLoader
    from repro_torch.kernels.flash_attention import backward as bwd
    from repro_torch.launch.train import train_lm
    from repro_torch.train import checkpoint as ckpt

    t_phase = time.perf_counter()
    attention_grad_checks(results)
    reduced = reduced_step_check()
    spec = get_spec("fastwarc_lm")
    shape = spec.shape("train_1k").params
    batch, seq = shape["global_batch"], shape["seq_len"]
    kw = dict(arch="fastwarc_lm", shards=paths, batch=batch, seq_len=seq,
              ckpt_every=TRAIN_CKPT_EVERY, log_every=5, device="cuda")
    ck_a, ck_b = workdir / "train-a", workdir / "train-b"
    fa.launches = bwd.launches = bwd.cuda_launches = 0
    torch.cuda.reset_peak_memory_stats()
    stats = train_lm(steps=TRAIN_STEPS, ckpt_dir=str(ck_a), **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {"flash_attention": fa.launches,
                "flash_attention_backward": bwd.launches,
                "flash_attention_backward (CUDA launches)": bwd.cuda_launches}
    if min(launches.values()) <= 0:
        raise RuntimeError(f"train_lm did not launch both kernels: {launches}")
    losses, step_s = stats["losses"], stats["step_s"]
    if not (len(losses) == TRAIN_STEPS and all(map(np.isfinite, losses))
            and np.mean(losses[-5:]) < np.mean(losses[:5])):
        raise RuntimeError(f"train_lm: the loss did not fall: {losses}")
    step_ms = float(np.median(step_s[1:])) * 1e3
    tok_s = batch * seq / (step_ms / 1e3)
    log(f"[train] (c) train_lm fastwarc_lm at full width, train_1k [{batch}, "
        f"{seq}], {TRAIN_STEPS} steps: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; step median {step_ms:.1f} ms (steps 1-"
        f"{TRAIN_STEPS - 1}, train_lm's step_s; step 0 "
        f"{step_s[0] * 1e3:.1f} ms) = {tok_s:.0f} tokens/s; train_lm's own "
        f"tokens/s over its wall {stats['tokens_per_s']:.0f}; peak device "
        f"memory {peak} bytes; launches a step: flash_attention "
        f"{launches['flash_attention'] / TRAIN_STEPS:g}, backward "
        f"{launches['flash_attention_backward'] / TRAIN_STEPS:g} calls = "
        f"{bwd.cuda_launches / TRAIN_STEPS:g} CUDA launches (as the C entry "
        f"counted them); {stats['straggler_events']} straggler events")

    # resume from the step-10 checkpoint
    ck_b.mkdir()
    shutil.copytree(ck_a / f"step_{TRAIN_CKPT_EVERY:09d}",
                    ck_b / f"step_{TRAIN_CKPT_EVERY:09d}")
    resumed = train_lm(steps=TRAIN_STEPS, ckpt_dir=str(ck_b), **kw)
    want = np.asarray(losses[TRAIN_CKPT_EVERY:])
    got = np.asarray(resumed["losses"])
    if got.shape != want.shape:
        raise RuntimeError(f"resumed train_lm ran {got.shape[0]} steps, "
                           f"not {want.shape[0]}")
    resume_err = float(np.abs(got - want).max())
    if not np.allclose(got, want, rtol=1e-5, atol=0):
        raise RuntimeError(f"resumed losses {got} != {want}")
    identical = bool(np.array_equal(got, want))

    # the batches train_lm was fed: its loader's, from the start (serial),
    # from the step-10 checkpoint's cursor, and with 2 pool workers
    # (forkserver: this process holds a CUDA context)
    def take(n, cursor=None, workers=0):
        loader = WarcTokenLoader(paths, batch=batch, seq_len=seq,
                                 workers=workers)
        if cursor is not None:
            loader.restore(cursor)
        try:
            it = iter(loader)
            return [next(it) for _ in range(n)]
        finally:
            loader.close()

    serial = take(TRAIN_STEPS)
    _, extras = ckpt.restore(str(ck_b), step=TRAIN_CKPT_EVERY)
    tail = take(TRAIN_STEPS - TRAIN_CKPT_EVERY, extras["loader"])
    if not all(np.array_equal(a, b)
               for a, b in zip(tail, serial[TRAIN_CKPT_EVERY:])):
        raise RuntimeError("the loader from the step-10 checkpoint's cursor "
                           "!= the uninterrupted loader's batches")
    log(f"[train] (c) resumed from step {TRAIN_CKPT_EVERY}: the "
        f"checkpoint's loader cursor gives {len(tail)} batches bit-identical "
        f"to the uninterrupted loader's; losses within rtol 1e-5 (max "
        f"|diff| {resume_err:.3g}, "
        f"{'bit-identical' if identical else 'not bit-identical'})")
    t0 = time.perf_counter()
    pooled = take(TRAIN_STEPS, workers=2)
    if not all(np.array_equal(a, b) for a, b in zip(pooled, serial)):
        raise RuntimeError("WarcTokenLoader(workers=2) != the serial "
                           "loader's batches")
    log(f"[train] (c) WarcTokenLoader(workers=2): {TRAIN_STEPS} batches "
        f"bit-identical to the serial loader's, "
        f"{time.perf_counter() - t0:.3f} s")
    shutil.rmtree(ck_a)
    shutil.rmtree(ck_b)
    results["train"] = {
        "reduced": reduced, "shape": [batch, seq], "steps": TRAIN_STEPS,
        "losses": losses, "step_s": step_s, "step_ms": step_ms,
        "tokens_per_s": tok_s, "train_lm_tokens_per_s": stats["tokens_per_s"],
        "peak_device_bytes": peak, "launches": launches,
        "launches_per_step": {k: v / TRAIN_STEPS for k, v in launches.items()},
        "resume": {"losses": resumed["losses"], "max_abs_diff": resume_err,
                   "bit_identical": identical},
        "phase_s": time.perf_counter() - t_phase}
    log(f"[train] phase 14 in {results['train']['phase_s']:.3f} s")


# -- phase 13 --------------------------------------------------------------
TABLE1_SPEC = CorpusSpec(n_pages=600, seed=42)  # Table 1's corpus
TABLE1_REPS = 3             # best of
TABLE1_WORKLOADS = {"parse": {"parse_http": False},
                    "+http": {"parse_http": True},
                    "+http+checksum": {"parse_http": True,
                                       "verify_digests": True}}
CODEC_SPEC = CorpusSpec(n_pages=2_000, seed=7)  # the mixed-codec corpus
DAMAGE = {"fraction": 0.01, "seed": 0}          # corrupt_warc of (f)


def have_zstandard() -> bool:
    """zstd is a host codec (the ``zstandard`` package), not the device:
    where it does not import, phase 13 leaves the zstd shard out."""
    try:
        import zstandard  # noqa: F401
    except ImportError:
        return False
    return True


def must_launch(label: str, count: int) -> int:
    if count <= 0:
        raise RuntimeError(f"codecs: {label} was never launched")
    return count


def best_rate(count) -> tuple[int, float]:
    """(records, best records/s of ``TABLE1_REPS`` runs of ``count()``)."""
    best, n = float("inf"), 0
    for _ in range(TABLE1_REPS):
        t0 = time.perf_counter()
        n = count()
        best = min(best, time.perf_counter() - t0)
    return n, n / best


def table1(codecs: tuple) -> dict:
    """Phase 13 (a): the paper's Table 1 on this host — records/s of the
    WARCIO baseline and the FastWARC-style iterator over codec x
    workload (WARCIO reads neither LZ4 nor zstd), and the response-only
    filtered pass as total records (yielded + skipped) per second."""
    total = records_in(TABLE1_SPEC)
    rows = []
    for comp in codecs:
        data = generate_warc(TABLE1_SPEC, comp)
        for workload, kw in TABLE1_WORKLOADS.items():
            n, fast = best_rate(lambda: sum(
                1 for _ in FastWARCIterator(data, **kw)))
            if n != total:
                raise RuntimeError(f"table1 {comp} {workload}: FastWARC "
                                   f"yielded {n} records, want {total}")
            row = {"codec": comp, "workload": workload, "parser": "fastwarc",
                   "records_per_s": fast}
            if comp in ("none", "gzip"):
                nb, base = best_rate(lambda: sum(
                    1 for _ in WARCIOArchiveIterator(data, **kw)))
                if nb != n:
                    raise RuntimeError(f"table1 {comp} {workload}: WARCIO "
                                       f"{nb} records, FastWARC {n}")
                rows.append({"codec": comp, "workload": workload,
                             "parser": "warcio", "records_per_s": base})
                row["speedup_vs_warcio"] = fast / base
            rows.append(row)
            if workload == "parse" and comp in ("gzip", "lz4"):
                # the members decoded in this process: what the decoder
                # child's start-up and hand-over cost or save
                _, inproc = best_rate(lambda: sum(1 for _ in FastWARCIterator(
                    data, readahead=False, **kw)))
                rows.append({"codec": comp, "workload": workload,
                             "parser": "fastwarc-no-readahead",
                             "records_per_s": inproc})
        it = FastWARCIterator(data, parse_http=False,
                              record_types=WarcRecordType.response)
        n_resp = sum(1 for _ in it)
        want_resp = TABLE1_SPEC.n_pages
        if n_resp != want_resp or it.records_skipped != total - want_resp:
            raise RuntimeError(f"table1 {comp} filtered: {n_resp} responses, "
                               f"{it.records_skipped} skipped of {total}")
        _, filt = best_rate(lambda: sum(1 for _ in FastWARCIterator(
            data, parse_http=False,
            record_types=WarcRecordType.response)) and total)
        rows.append({"codec": comp, "workload": "filter-response",
                     "parser": "fastwarc", "records_per_s": filt})
    gzip_parse = next(r["records_per_s"] for r in rows
                      if r["codec"] == "gzip" and r["parser"] == "fastwarc"
                      and r["workload"] == "parse")
    for r in rows:
        if r["parser"] == "fastwarc" and r["workload"] == "parse" and \
                r["codec"] in ("lz4", "zstd"):
            r["speedup_vs_fastwarc_gzip"] = r["records_per_s"] / gzip_parse
    for r in rows:
        extra = "".join(f", {k} {r[k]:.3f}" for k in (
            "speedup_vs_warcio", "speedup_vs_fastwarc_gzip") if k in r)
        log(f"[codecs] (a) table1 {r['codec']:4} {r['workload']:15} "
            f"{r['parser']:21} {r['records_per_s']:.1f} records/s{extra}")
    return {"records": total, "reps": TABLE1_REPS, "rows": rows}


def shard_rows(index: CdxIndex) -> list[np.ndarray]:
    return [np.flatnonzero(index.shard_id == s)
            for s in range(len(index.shard_paths))]


def codec_build(paths: list[str], codecs: tuple, out: dict) -> CdxIndex:
    """Phase 13 (b): one seeded corpus written once per codec, indexed in
    one ``build_index`` on the card; the gzip and LZ4 sweeps must run the
    child-process member decoder."""
    obs.reset()
    ds.launches = 0
    t0 = time.perf_counter()
    index = build_index(paths, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c = obs.snapshot().counters
    rows = shard_rows(index)
    members = sum(rows[codecs.index(k)].size for k in ("gzip", "lz4"))
    decoders = {k: c.get(f"ingest.readahead.{k}", 0)
                for k in ("process", "thread")}
    if decoders != {"process": 2, "thread": 0} or \
            c.get("decoder.members", 0) != members:
        raise RuntimeError(f"codecs (b): the gzip and LZ4 sweeps did not run "
                           f"the child-process decoder: {decoders}, "
                           f"{c.get('decoder.members', 0)} of {members} "
                           f"members decoded in a child")
    for name in ("rtype", "status", "uncomp_len", "digest", "signatures"):
        col = getattr(index, name)
        for s in range(1, len(rows)):
            if not np.array_equal(col[rows[s]], col[rows[0]]):
                raise RuntimeError(f"codecs (b): {name} of the {codecs[s]} "
                                   f"shard != the uncompressed shard's")
    for s in range(1, len(rows)):
        for i, j in zip(rows[s], rows[0]):
            if index.uri(i) != index.uri(j) or index.mime(i) != index.mime(j):
                raise RuntimeError(f"codecs (b): row {i}: URI or MIME != the "
                                   f"uncompressed shard's")
    for j, rec in zip(rows[0], FastWARCIterator(paths[0], parse_http=False)):
        if int(index.digest[j]) != zlib.adler32(rec.content_view()):
            raise RuntimeError(f"codecs (b): row {j}: digest != zlib.adler32")
    if "zstd" in codecs and any(
            index.frame_hint(int(i)) is None
            for i in rows[codecs.index("zstd")]):
        raise RuntimeError("codecs (b): a zstd row has no frame hint")
    stage = {k: c.get(f"index.stage.{k}_us", 0) / 1e6
             for k in ("parse", "digest_sig", "frame_walk", "assemble")}
    out["build"] = {"records": len(index), "seconds": dt,
                    "records_per_s": len(index) / dt, "stages_s": stage,
                    "decoder_members": members, **decoders}
    out["launches"]["digest_sig (build)"] = must_launch(
        "digest_sig in the mixed-codec build", ds.launches)
    log(f"[codecs] (b) build_index over {len(codecs)} shards ({', '.join(codecs)}"
        f") x {rows[0].size} records: {dt:.3f} s = {len(index) / dt:.1f} "
        f"records/s; stages (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
        + f"; {ds.launches} digest_sig launches; rtype/status/uncomp_len/"
        f"digest/signatures/URI/MIME equal across the shards; every digest "
        f"== zlib.adler32; {members} gzip/LZ4 members decoded in child "
        f"processes ({decoders})")
    return index


def codec_search(index: CdxIndex, paths: list[str], out: dict) -> dict:
    """Phase 13 (c): phase 6's requests over the mixed index; each hit
    list equal to the oracle, and equal across the shards record by
    record. Returns ``label -> {(shard, offset): matches}``."""
    rows = shard_rows(index)
    ordinal = {(index.shard_paths[s], int(index.offset[i])): (s, k)
               for s, r in enumerate(rows) for k, i in enumerate(r)}
    reqs = [QueryRequest(r.pattern, r.filters, top_k=len(index),
                         regex=r.regex) for _, r in REQUESTS]
    ps.launches = 0
    t0 = time.perf_counter()
    with IndexQueryService(index, device="cuda") as svc:
        responses = svc.serve(reqs)
        masks = [None if r.filters is None
                 else svc.engine.header_mask(r.filters) for r in reqs]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    hits = {}
    for (label, _), req, mask, resp in zip(REQUESTS, reqs, masks, responses):
        # the records are the same in every shard: the oracle of the
        # uncompressed shard, by record ordinal, stands for all four
        scan = (full_scan_regex if req.regex else full_scan_search)(
            paths[:1], req.pattern)
        want = {ordinal[k][1]: v for k, v in scan.items()
                if mask is None or mask[rows[0][ordinal[k][1]]]}
        got = {(h.shard, h.offset): h.n_matches for h in resp.hits}
        per = [{} for _ in rows]
        for key, n in got.items():
            s, k = ordinal[key]
            per[s][k] = n
        if any(p != want for p in per) or \
                resp.total_matches != len(rows) * len(want):
            raise RuntimeError(f"codecs (c) {label!r}: per-shard hits "
                               f"{[len(p) for p in per]} != the "
                               f"{len(want)}-record oracle")
        hits[label] = got
        log(f"[codecs] (c) {label} {req.pattern!r}: {len(want)} records in "
            f"each of the {len(rows)} shards == oracle, "
            f"{resp.latency_s * 1e3:.3f} ms")
    out["search"] = {"seconds": dt, "requests": len(reqs),
                     "hits": {k: len(v) for k, v in hits.items()}}
    out["launches"]["pattern_scan (search)"] = must_launch(
        "pattern_scan_batch in the mixed-codec search", ps.launches)
    log(f"[codecs] (c) {len(reqs)} requests in {dt:.3f} s; {ps.launches} "
        f"pattern_scan_batch launches")
    return hits


def codec_verify(index: CdxIndex, codecs: tuple, out: dict) -> None:
    """Phase 13 (d): ``verify_index`` on the card, all True; then one LZ4
    and one zstd digest flipped, exactly those rows False."""
    ad.launches = 0
    t0 = time.perf_counter()
    ok = verify_index(index, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not all(ok):
        raise RuntimeError(f"codecs (d): {ok.count(False)} rows fail verify")
    rows = shard_rows(index)
    rng = np.random.default_rng(SEED)
    flips = sorted(int(rng.choice(rows[codecs.index(k)]))
                   for k in ("lz4", "zstd") if k in codecs)
    index.digest[flips] ^= np.uint32(1)
    try:
        bad = [i for i, v in enumerate(verify_index(index, device="cuda"))
               if not v]
    finally:
        index.digest[flips] ^= np.uint32(1)
    if bad != flips:
        raise RuntimeError(f"codecs (d): rows {bad} failed, flipped {flips}")
    out["verify"] = {"records": len(index), "seconds": dt,
                     "records_per_s": len(index) / dt, "flipped": flips}
    out["launches"]["adler32 (verify)"] = must_launch(
        "adler32 in the mixed-codec verify", ad.launches)
    log(f"[codecs] (d) verify_index over {len(index)} records: all True in "
        f"{dt:.3f} s = {len(index) / dt:.1f} records/s; flipped digests of "
        f"rows {flips} ({', '.join(k for k in ('lz4', 'zstd') if k in codecs)}"
        f"): exactly those False; {ad.launches} adler32 launches")


def codec_derive(index: CdxIndex, paths: list[str], codecs: tuple,
                 hits: dict, workdir: Path, out: dict) -> None:
    """Phase 13 (e): ``derive`` of the LZ4 and zstd shards on the card,
    the store's columns equal to (b)'s rows, and one columnar search
    equal to (c)'s hits."""
    sub = [p for p, k in zip(paths, codecs) if k in ("lz4", "zstd")]
    rows = np.flatnonzero(np.isin(index.shard_id, [
        codecs.index(k) for k in ("lz4", "zstd") if k in codecs]))
    ds.launches = 0
    t0 = time.perf_counter()
    store = derive(sub, str(workdir / "codecs.repcol"), device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    derive_launches = ds.launches
    for col, idx_col in STORE_COLUMNS:
        if col in ("shard_id", "uri_off", "mime_off"):
            continue
        if not np.array_equal(getattr(store, col),
                              getattr(index, idx_col)[rows]):
            raise RuntimeError(f"codecs (e): store column {col} != (b)'s")
    for i, j in enumerate(rows):
        if store.uri(i) != index.uri(j) or store.mime(i) != index.mime(j):
            raise RuntimeError(f"codecs (e): store row {i}: URI or MIME != "
                               f"(b)'s")
    label, req = REQUESTS[0]
    ps.rowgroup_launches = 0
    engine = QueryEngine.from_store(store, device="cuda")
    with IndexQueryService(engine.index, engine=engine) as svc:
        (resp,) = svc.serve([QueryRequest(req.pattern, top_k=len(store))])
    torch.cuda.synchronize()
    got = {(h.shard, h.offset): h.n_matches for h in resp.hits}
    want = {k: v for k, v in hits[label].items() if k[0] in sub}
    if got != want or not got:
        raise RuntimeError(f"codecs (e): columnar {label!r} gave {len(got)} "
                           f"hits, (c) {len(want)}")
    del engine, svc
    gc.collect()
    store.close()
    out["derive"] = {"records": int(rows.size), "seconds": dt,
                     "records_per_s": rows.size / dt,
                     "columnar_hits": len(got)}
    out["launches"]["digest_sig (derive)"] = must_launch(
        "digest_sig in the LZ4/zstd derive", derive_launches)
    out["launches"]["pattern_scan_rowgroup (columnar search)"] = must_launch(
        "pattern_scan_rowgroup in the LZ4/zstd columnar search",
        ps.rowgroup_launches)
    log(f"[codecs] (e) derive of the LZ4 and zstd shards: {rows.size} "
        f"records in {dt:.3f} s; columns and heaps == (b)'s rows; "
        f"{derive_launches} digest_sig launches; columnar {label} "
        f"{req.pattern!r}: {len(got)} hits == (c)'s; "
        f"{ps.rowgroup_launches} pattern_scan_rowgroup launches")


def record_ids(path: str, **kw) -> list[bytes]:
    return [rec.header_bytes(b"WARC-Record-ID:")
            for rec in FastWARCIterator(path, parse_http=False, **kw)]


def codec_tolerant(index: CdxIndex, paths: list[str], codecs: tuple,
                   workdir: Path, out: dict) -> None:
    """Phase 13 (f): ``build_index(tolerant=True)`` on the card over
    damaged copies of the gzip and the LZ4 shard; every surviving row
    equal to the intact index's row of the same record ID."""
    rows = shard_rows(index)
    damaged, intact, spans = [], [], 0
    for comp in ("gzip", "lz4"):
        s = codecs.index(comp)
        with open(paths[s], "rb") as f:
            bad, hit = corrupt_warc(f.read(), **DAMAGE)
        p = workdir / f"damaged.{comp}.warc"
        p.write_bytes(bad)
        damaged.append(str(p))
        intact.append(s)
        spans += len(hit)
    ds.launches = 0
    t0 = time.perf_counter()
    got = build_index(damaged, tolerant=True, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not got.errors:
        raise RuntimeError("codecs (f): the tolerant build ledgered nothing")
    for t, (s, path) in enumerate(zip(intact, damaged)):
        want_ids = record_ids(paths[s])
        row_of_id = {rid: rows[s][k] for k, rid in enumerate(want_ids)}
        trows = np.flatnonzero(got.shard_id == t)
        ids = record_ids(path, tolerant=True)
        if len(ids) != trows.size or not trows.size or \
                trows.size >= len(want_ids):
            raise RuntimeError(f"codecs (f): {trows.size} rows for "
                               f"{len(ids)} surviving records")
        want = np.asarray([row_of_id[rid] for rid in ids])
        for name in CDX_COLUMNS:
            if name in ("shard_id", "comp_len", "uri_off", "mime_off"):
                continue  # the heaps are compared record by record below
            a, b = getattr(got, name), getattr(index, name)
            if not np.array_equal(a[trows], b[want]):
                raise RuntimeError(f"codecs (f) {codecs[s]}: column {name} "
                                   f"of a surviving row != the intact row")
        # comp_len runs to the next indexed record: over a lost member
        # it spans the lost bytes too
        ends = np.append(index.offset[want][1:],
                         np.uint64(os.path.getsize(path)))
        if not np.array_equal(got.comp_len[trows],
                              ends - index.offset[want]):
            raise RuntimeError(f"codecs (f) {codecs[s]}: comp_len != the "
                               f"distance to the next surviving record")
        for i, j in zip(trows, want):
            if got.uri(i) != index.uri(j) or got.mime(i) != index.mime(j):
                raise RuntimeError(f"codecs (f): row {i}: URI or MIME != "
                                   f"the intact row's")
    left = glob.glob(f"/dev/shm/{SHM_PREFIX}-*")
    if left:
        raise RuntimeError(f"codecs (f): shared-memory segments left: {left}")
    ledger = {}
    for e in got.errors:
        ledger[e.error_class] = ledger.get(e.error_class, 0) + 1
    out["tolerant"] = {"records": len(got), "seconds": dt,
                       "damaged_members": spans, "ledger": ledger}
    out["launches"]["digest_sig (tolerant build)"] = must_launch(
        "digest_sig in the tolerant build", ds.launches)
    log(f"[codecs] (f) tolerant build over the damaged gzip and LZ4 shards "
        f"({spans} members garbled): {len(got)} rows in {dt:.3f} s, ledger "
        f"{ledger}; every surviving row == the intact row of its record ID "
        f"(comp_len: up to the next surviving record); "
        f"{ds.launches} digest_sig launches; /dev/shm/{SHM_PREFIX}-* left: "
        f"none")


def codec_phase(workdir: Path, results: dict) -> None:
    """Phase 13: LZ4, zstd and uncompressed shards beside gzip — the
    paper's Table 1 on this host, then a mixed-codec build, search,
    verify, derive and tolerant build on the card."""
    t_phase = time.perf_counter()
    codecs = ("none", "gzip", "lz4")
    if have_zstandard():
        codecs += ("zstd",)
    else:
        log("[codecs] zstandard does not import on this host: the zstd "
            "shard and Table 1's zstd cells are left out (a host codec; "
            "the device path is the same)")
    out: dict = {"codecs": list(codecs), "launches": {}}
    out["table1"] = table1(codecs)
    d = workdir / "codecs"
    d.mkdir(parents=True, exist_ok=True)
    paths, sizes = [], {}
    t0 = time.perf_counter()
    for comp in codecs:
        p = d / f"mixed.{comp}.warc"
        p.write_bytes(generate_warc(CODEC_SPEC, comp))
        paths.append(str(p))
        sizes[comp] = p.stat().st_size
    out["write_s"] = time.perf_counter() - t0
    log(f"[codecs] (b) corpus CorpusSpec(n_pages={CODEC_SPEC.n_pages}, "
        f"seed={CODEC_SPEC.seed}) written once per codec in "
        f"{out['write_s']:.3f} s; bytes {sizes}")
    out["bytes"] = sizes
    index = codec_build(paths, codecs, out)
    hits = codec_search(index, paths, out)
    codec_verify(index, codecs, out)
    codec_derive(index, paths, codecs, hits, d, out)
    codec_tolerant(index, paths, codecs, d, out)
    out["phase_s"] = time.perf_counter() - t_phase
    results["codecs"] = out
    log(f"[codecs] phase 13 in {out['phase_s']:.3f} s; launches "
        f"{out['launches']}")


# -- phase 15 --------------------------------------------------------------
MOE_ARCH = "qwen3_moe_30b_a3b"
MOE_PREFILL_RUNS = 5         # timed prefill forwards after one warm-up
MOE_NEW_TOKENS = 16          # the engine's new tokens a request
MOE_PROMPT_BYTES = (32, 64)  # the engine's common prompt length, drawn here
# #7's paths for Qwen3-30B-A3B (GQA group 8, D = 128, bf16): every launch
# of a forward, and of a decode step, must take these
MOE_PREFILL_PATH = "prefill_tc"
MOE_DECODE_PATH = "decode_tc"
# moe_apply against moe_apply_plain on the card, both bf16: the same
# products in other GEMM shapes and the combine summed in another order,
# so each bf16 rounding (h, the expert output, the sum) may land an ulp
# apart; 2^-6 is 4 ulps of the element, or of the output's rms where the
# k terms cancel
MOE_DISPATCH_TOL = 2.0 ** -6
# the engine's tokens against forward's argmax are held where forward's
# top-2 logit gap exceeds this margin. Both paths round through 48 bf16
# layers in other shapes (decode vs prefill attention, GEMV vs GEMM), so
# their logits differ by some bf16 ulps (2^-6 for logits in [2, 4)): the
# largest difference over every position, 0.1062 on the H100 (0.0938 and
# 0.0996 over the generated ones in two earlier runs), is held below half
# the margin, 16 ulps; a token can flip only where the gap is below twice
# that difference
MOE_TIE_MARGIN = 2.0 ** -1


def kernel_times(prof) -> dict:
    """Device seconds by kernel name from a ``torch.profiler`` run
    (device-side events only: an aten op's row repeats its kernels')."""
    by_kernel: dict = {}
    for e in prof.key_averages():
        t = e.self_device_time_total
        if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + t / 1e6
    return by_kernel


def forward_profile(params, cfg, tokens: torch.Tensor) -> dict:
    """One ``forward`` over ``tokens`` under ``torch.profiler``: device
    time by kernel against an unprofiled run's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        t0 = time.perf_counter()
        tf.forward(params, tokens, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tf.forward(params, tokens, cfg)
            torch.cuda.synchronize()
    by_kernel = kernel_times(prof)
    device = sum(by_kernel.values())
    flash = sum(t for k, t in by_kernel.items()
                if "flash_fwd" in k or "flash_decode" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_s": wall, "device_s": device if device else None,
            "busy_share": device / wall if device else None,
            "flash_s": flash, "top_kernels_s": top}


def moe_reduced_check(payloads: list[bytes]) -> dict:
    """(a) The reduced Qwen3-MoE as its spec defines it (f32, d_head 16,
    8 experts, top-2) on the card: forward over 2 x 64 seeded tokens
    within rtol/atol 2e-4 of the CPU forward (logits and aux) with the
    same seeded weights, and the engine's greedy tokens for 4 corpus
    prompts equal to the CPU engine's."""
    cfg = get_spec(MOE_ARCH).reduced
    gpu = tf.init_params(cfg, generator=torch.Generator().manual_seed(SEED))
    cpu = tf.init_params(cfg, generator=torch.Generator().manual_seed(SEED),
                         device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(SEED + 15).integers(
        0, cfg.vocab, (2, 64)))
    before = fa.launches
    with torch.inference_mode():
        got, aux = tf.forward(gpu, tokens.cuda(), cfg)
        torch.cuda.synchronize()
        want, aux_w = tf.forward(cpu, tokens, cfg)
    diff = float((got.cpu() - want).abs().max())
    try:
        torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(aux.cpu(), aux_w, rtol=2e-4, atol=2e-4)
    except AssertionError as exc:
        raise RuntimeError(f"reduced {cfg.name}: card != CPU forward: "
                           f"{exc}") from None
    prompts = [p[:48] for p in payloads[:4]]
    outs = []
    for params, dev in ((gpu, "cuda"), (cpu, "cpu")):
        engine = ServeEngine(cfg, params, batch_size=2, max_seq=96,
                             temperature=0.0, device=dev)
        outs.append([r.out_tokens for r in engine.serve(
            [Request(p, max_new_tokens=16) for p in prompts])])
    torch.cuda.synchronize()
    launches = fa.launches - before
    if outs[0] != outs[1] or launches <= 0:
        raise RuntimeError(f"reduced {cfg.name}: engine tokens card "
                           f"{outs[0]} != CPU {outs[1]} (or no launch: "
                           f"{launches})")
    log(f"[moe] (a) reduced {cfg.name} ({cfg.moe_experts} experts, top-"
        f"{cfg.moe_top_k}, d_head {cfg.d_head}) on the card: forward "
        f"[2, 64] == CPU forward, max |card - CPU| = {diff:.3g}, aux "
        f"{float(aux):.6f} (CPU {float(aux_w):.6f}); greedy tokens of 4 "
        f"prompts == the CPU engine's ({sum(map(len, outs[0]))} tokens); "
        f"{launches} flash_attention launches")
    return {"max_abs_diff_vs_cpu": diff, "aux": float(aux),
            "engine_tokens": sum(map(len, outs[0])), "launches": launches}


def moe_layer_walk(params, cfg, tokens: torch.Tensor) -> dict:
    """(c) The prefill batch layer by layer (the blocks ``forward`` runs):
    each layer's dropped assignments, and at layer 0 ``moe_apply``
    against ``moe_apply_plain`` on its normalised hidden states — the
    same chosen experts, the same kept assignments, outputs within
    ``MOE_DISPATCH_TOL``."""
    B, S = tokens.shape
    kw = {"top_k": cfg.moe_top_k, "capacity_factor": cfg.capacity_factor}
    cos, sin = rope_cos_sin(torch.arange(S, device="cuda"), cfg.d_head,
                            cfg.rope_theta)
    drops, out = [], {}
    with torch.inference_mode():
        x = params.embed[tokens]
        for i, lp in enumerate(params.layers):
            x = tf._attention_block(lp, x, cfg, cos, sin)
            h = rmsnorm(lp.ln2, x).reshape(B * S, cfg.d_model)
            r = moe.moe_route(lp.moe, h, **kw)
            drops.append(r.dropped)
            y, aux = moe.moe_apply(lp.moe, h, **kw)
            if i == 0:
                out = moe_dispatch_check(lp.moe, h, r, y, aux, kw)
            x = x + y.view(B, S, cfg.d_model)
    out.update(drops_by_layer=drops, dropped=sum(drops),
               assignments=B * S * cfg.moe_top_k * cfg.n_layers)
    log(f"[moe] (c) prefill [{B}, {S}] layer by layer: {sum(drops)} of "
        f"{out['assignments']} assignments dropped over {cfg.n_layers} "
        f"layers (capacity {out['capacity']} slots an expert a layer; per "
        f"layer {min(drops)}-{max(drops)}, layer 0 {drops[0]})")
    return out


def moe_dispatch_check(p, h, r, y, aux, kw: dict) -> dict:
    p_out, p_aux, experts, kept = moe.moe_apply_plain(p, h, **kw)
    torch.cuda.synchronize()
    k = kw["top_k"]
    if not torch.equal(r.experts.reshape(-1, k), experts):
        raise RuntimeError("moe_apply and moe_apply_plain chose other "
                           "experts on the card")
    if not torch.equal(r.kept.reshape(-1, k), kept):
        raise RuntimeError("moe_apply and moe_apply_plain dropped other "
                           "assignments on the card")
    rms = float(p_out.float().pow(2).mean().sqrt())
    err = float((y.float() - p_out.float()).abs().max())
    try:
        torch.testing.assert_close(y.float(), p_out.float(),
                                   rtol=MOE_DISPATCH_TOL,
                                   atol=MOE_DISPATCH_TOL * rms)
        torch.testing.assert_close(aux, p_aux, rtol=1e-5, atol=1e-7)
    except AssertionError as exc:
        raise RuntimeError(f"moe_apply != moe_apply_plain on the card: "
                           f"{exc}") from None
    ms = time_ms(lambda: moe.moe_apply(p, h, **kw), 5)
    pms = time_ms(lambda: moe.moe_apply_plain(p, h, **kw), 3)
    dropped = int((~kept).sum())
    log(f"[moe] (c) layer 0: moe_apply == moe_apply_plain on the card: the "
        f"same experts and the same {dropped} dropped assignments of "
        f"{kept.numel()}; max |dispatch - plain| = {err:.3g} (output rms "
        f"{rms:.3g}, tolerance {MOE_DISPATCH_TOL:.3g} x (|plain| + rms)), "
        f"aux {float(aux):.6f}; {ms:.3f} ms dispatched, {pms:.3f} ms plain")
    return {"layer0_dropped": dropped, "capacity": r.capacity,
            "layer0_max_abs_err": err, "layer0_out_rms": rms,
            "moe_apply_ms": ms, "moe_apply_plain_ms": pms}


def moe_engine_check(params, cfg, done: list, step_logits: list,
                     prompt_tokens: int) -> dict:
    """(e) The engine's steps against one ``forward`` over each prompt
    and the engine's generated tokens (teacher forcing), with
    ``capacity_factor = E / k`` so no assignment drops: the function the
    engine's decode steps compute (``C = 8`` slots at batch 8: nothing
    can drop). Over every position of every row, prompt and generated,
    the largest |forward - decode step| logit must stay below half of
    ``MOE_TIE_MARGIN``; each generated token must be forward's argmax
    wherever forward's top-2 gap exceeds the margin (else a near-tie)."""
    rows = [[BOS_ID, *encode(r.prompt).tolist(), *r.out_tokens[:-1]]
            for r in done]
    width = max(map(len, rows))
    ids = torch.tensor([row + [0] * (width - len(row)) for row in rows],
                       device="cuda")
    no_drop = cfg.scaled(capacity_factor=cfg.moe_experts / cfg.moe_top_k)
    with torch.inference_mode():
        logits, _ = tf.forward(params, ids, no_drop)
        steps = torch.stack(step_logits[:width], dim=1)   # [B, width, V]
        diff = 0.0
        for j, row in enumerate(rows):  # a finished row's later steps
            n = len(row)                # ran on tokens it did not record
            diff = max(diff, float((logits[j, :n].float()
                                    - steps[j, :n].float()).abs().max()))
        del steps
    near, mismatch, checked, min_gap = 0, [], 0, float("inf")
    for j, r in enumerate(done):
        top = logits[j, prompt_tokens - 1:prompt_tokens - 1
                     + len(r.out_tokens)].float().topk(2, dim=-1)
        gaps = (top.values[:, 0] - top.values[:, 1]).tolist()
        for i, (t, want, gap) in enumerate(zip(
                r.out_tokens, top.indices[:, 0].tolist(), gaps)):
            min_gap = min(min_gap, gap)
            if gap <= MOE_TIE_MARGIN:
                near += 1
            elif want != t:
                mismatch.append((j, i, t, want, gap))
            else:
                checked += 1
    if mismatch:
        raise RuntimeError(f"engine tokens != forward's argmax past the "
                           f"margin (request, position, engine, forward, "
                           f"gap): {mismatch}")
    if diff >= MOE_TIE_MARGIN / 2:
        raise RuntimeError(f"|forward - decode step| logits reach {diff} "
                           f">= {MOE_TIE_MARGIN / 2}: past bf16 rounding, "
                           f"and the near-tie margin no longer covers them")
    return {"checked": checked, "near_ties": near, "min_top2_gap": min_gap,
            "positions_compared": sum(map(len, rows)),
            "max_abs_logit_diff_forward_vs_decode": diff}


def moe_full_width(payloads: list[bytes], rng) -> dict:
    """(b)-(e) Qwen3-30B-A3B at full width in bf16."""
    cfg = get_spec(MOE_ARCH).config
    batch = get_spec("fastwarc_lm").shape("serve_1k").params["global_batch"]
    seq = get_spec("fastwarc_lm").shape("serve_1k").params["seq_len"]
    out: dict = {"model": cfg.name, "step_s": {}}
    t_lap = [time.perf_counter()]

    def lap(name: str) -> None:  # seconds since the previous lap
        now = time.perf_counter()
        out["step_s"][name] = now - t_lap[0]
        t_lap[0] = now

    # (b) weights drawn on the card
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    n_params = sum(t.numel() for t in params.parameters())
    kinds = {(t.device.type, t.dtype) for t in params.parameters()}
    if n_params != cfg.param_count() or n_params != 30_532_110_336 or \
            kinds != {("cuda", torch.bfloat16)}:
        raise RuntimeError(f"{n_params} parameters ({kinds}); the config "
                           f"says {cfg.param_count()}")
    out.update(parameters=n_params,
               active_parameters=cfg.active_param_count(),
               weights_bytes=2 * n_params,
               after_load_bytes=torch.cuda.memory_allocated(),
               load_peak_bytes=torch.cuda.max_memory_allocated())
    log(f"[moe] (b) {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} q heads / {cfg.n_kv_heads} kv heads "
        f"(group {cfg.n_heads // cfg.n_kv_heads}), d_head {cfg.d_head}, "
        f"{cfg.moe_experts} experts top-{cfg.moe_top_k}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, {cfg.dtype}: {n_params} parameters "
        f"({cfg.active_param_count()} active a token) drawn on the card "
        f"from a CUDA generator seeded {SEED} in {out['load_s']:.3f} s; "
        f"{out['after_load_bytes']} bytes allocated after the load (peak "
        f"{out['load_peak_bytes']})")

    pick = rng.choice(len(payloads), 2 * batch, replace=False)
    tokens = np.stack([np.concatenate(
        ([BOS_ID], encode(payloads[i][:seq - 1]))) for i in pick[:batch]])
    tok_d = torch.from_numpy(tokens).cuda()
    lap("load")
    out.update(moe_layer_walk(params, cfg, tok_d))
    lap("layer walk")

    # (d) prefill
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    fa.path_launches.update(dict.fromkeys(fa.PATHS, 0))
    times, logits = [], None
    with torch.inference_mode():
        for run in range(MOE_PREFILL_RUNS + 1):  # run 0 warms up
            logits = None
            t0 = time.perf_counter()
            logits, aux = tf.forward(params, tok_d, cfg)
            torch.cuda.synchronize()
            if run:
                times.append(time.perf_counter() - t0)
    prefill_launches = fa.launches
    prefill_paths = {p: n for p, n in fa.path_launches.items() if n}
    if prefill_paths != {MOE_PREFILL_PATH: cfg.n_layers
                         * (MOE_PREFILL_RUNS + 1)}:
        raise RuntimeError(f"flash_attention launches by path in "
                           f"{MOE_PREFILL_RUNS + 1} forwards: "
                           f"{prefill_paths}, not {cfg.n_layers} a forward "
                           f"on {MOE_PREFILL_PATH}")
    if logits.shape != (batch, seq, cfg.vocab) or not bool(
            torch.isfinite(logits).all()) or not np.isfinite(float(aux)):
        raise RuntimeError(f"prefill logits {tuple(logits.shape)} or aux "
                           f"not finite, or of the wrong shape")
    prefill_s = float(np.median(times))
    out.update(prefill_shape=[batch, seq], prefill_runs_s=times,
               prefill_s=prefill_s,
               prefill_tokens_per_s=batch * seq / prefill_s,
               prefill_peak_bytes=torch.cuda.max_memory_allocated(),
               aux=float(aux))
    logits = None
    lap("prefill")
    out["prefill_profile"] = forward_profile(params, cfg, tok_d)
    lap("prefill profile")
    log(f"[moe] (d) prefill forward [{batch}, {seq}]: median of "
        f"{MOE_PREFILL_RUNS} {prefill_s * 1e3:.3f} ms (runs "
        f"{', '.join(f'{t * 1e3:.3f}' for t in times)} ms) = "
        f"{batch * seq / prefill_s:.1f} prefill tokens/s; "
        f"{prefill_launches} flash_attention launches ({cfg.n_layers} a "
        f"forward, by path {prefill_paths}); logits finite, aux "
        f"{out['aux']:.6f}; peak device "
        f"memory {out['prefill_peak_bytes']} bytes; profiled forward: "
        + profile_line(out["prefill_profile"]))

    # (e) the engine: 8 corpus prompts of one length, 16 new tokens each
    plen = int(rng.integers(MOE_PROMPT_BYTES[0], MOE_PROMPT_BYTES[1] + 1))
    prompts = [payloads[i][:plen] for i in pick[batch:]]
    engine = ServeEngine(cfg, params, batch_size=batch, max_seq=seq,
                         temperature=0.0, device="cuda")
    step_logits: list = []
    decode_step = tf.decode_step

    def recording_step(*args, **kw):  # keeps each step's logits
        logits, cache = decode_step(*args, **kw)
        step_logits.append(logits)
        return logits, cache

    prev = trace.enable(True)
    spans0 = {k: span_sum(k) for k in ("serve.prefill", "serve.decode")}
    torch.cuda.reset_peak_memory_stats()
    before = fa.launches
    fa.path_launches.update(dict.fromkeys(fa.PATHS, 0))
    tf.decode_step = recording_step
    t0 = time.perf_counter()
    try:
        done = engine.serve([Request(p, max_new_tokens=MOE_NEW_TOKENS)
                             for p in prompts])
    finally:
        tf.decode_step = decode_step
        trace.enable(prev)
    wall = time.perf_counter() - t0
    lap("engine")
    engine_launches = fa.launches - before
    engine_paths = {p: n for p, n in fa.path_launches.items() if n}
    peak = torch.cuda.max_memory_allocated()
    spans = {k: span_sum(k) - spans0[k] for k in spans0}
    generated = engine.stats["tokens_generated"]
    # the engine prefills its prompts token by token: every launch is a
    # decode step's, one a layer
    if engine_paths != {MOE_DECODE_PATH: cfg.n_layers * len(step_logits)} \
            or not all(
            r.done and 0 < len(r.out_tokens) <= MOE_NEW_TOKENS
            and all(0 <= t < cfg.vocab for t in r.out_tokens)
            for r in done):
        raise RuntimeError(f"engine: flash_attention launches by path "
                           f"{engine_paths} over {len(step_logits)} steps "
                           f"(not {cfg.n_layers} a step on "
                           f"{MOE_DECODE_PATH}), or a request unfinished")
    decode_cap = moe.expert_capacity(batch * cfg.moe_top_k, cfg.moe_experts,
                                     cfg.moe_top_k,
                                     max(cfg.capacity_factor, 2.0))
    check = moe_engine_check(params, cfg, done, step_logits, plen + 1)
    del step_logits
    lap("engine check")
    prof = decode_profile(params, cfg, batch, seq, plen + 1, n_steps=2)
    lap("decode profile")
    out.update(
        prompt_bytes=plen, engine_requests=len(done),
        tokens_generated=generated, engine_wall_s=wall,
        serve_prefill_s=spans["serve.prefill"],
        serve_decode_s=spans["serve.decode"],
        decode_tokens_per_s=generated / spans["serve.decode"],
        engine_peak_bytes=peak, decode_capacity=decode_cap,
        decode_profile=prof, tie_margin=MOE_TIE_MARGIN, **check,
        flash_launches={"moe prefill": prefill_launches,
                        "moe engine": engine_launches},
        flash_paths={"moe prefill": prefill_paths,
                     "moe engine": engine_paths})
    log(f"[moe] (e) ServeEngine(batch_size={batch}, max_seq={seq}, greedy): "
        f"{len(done)} requests of {plen} payload bytes, {generated} tokens "
        f"generated in {wall:.3f} s; serve.prefill "
        f"{spans['serve.prefill']:.3f} s, serve.decode "
        f"{spans['serve.decode']:.3f} s = "
        f"{out['decode_tokens_per_s']:.1f} decode tokens/s; "
        f"{engine_launches} flash_attention launches (by path "
        f"{engine_paths}); peak device memory "
        f"{peak} bytes; decode capacity {decode_cap} slots an expert "
        f"(batch {batch}: nothing drops); {check['checked']} tokens == "
        f"forward's argmax, {check['near_ties']} near-ties (top-2 gap <= "
        f"{MOE_TIE_MARGIN}, smallest gap {check['min_top2_gap']:.4g}); "
        f"max |forward - decode step| logit "
        f"{check['max_abs_logit_diff_forward_vs_decode']:.4g} over "
        f"{check['positions_compared']} positions (limit "
        f"{MOE_TIE_MARGIN / 2}); decode "
        f"profile, 2 steps at cache length {plen + 1}: "
        + profile_line(prof))
    return out


def profile_line(prof: dict) -> str:
    if prof["device_s"] is None:
        return "the profiler saw no device time (busy share not measured)"
    return (f"wall {prof['wall_s'] * 1e3:.3f} ms, device "
            f"{prof['device_s'] * 1e3:.3f} ms, busy share "
            f"{prof['busy_share']:.4f}, flash_attention "
            f"{prof['flash_s'] * 1e3:.3f} ms; top kernels (ms): "
            + "; ".join(f"{k[:60]} {t * 1e3:.3f}"
                        for k, t in prof["top_kernels_s"]))


def moe_phase(paths: list[str], results: dict) -> None:
    """Phase 15: Qwen3-30B-A3B served at full width on the card."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    log(f"[moe] device memory allocated before the phase: {before} bytes")
    payloads = response_payloads(paths[0], 512)
    t0 = time.perf_counter()
    out = {"reduced": moe_reduced_check(payloads)}
    out["reduced"]["s"] = time.perf_counter() - t0
    out.update(moe_full_width(payloads, np.random.default_rng(SEED + 15)))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    out.update(allocated_before=before, allocated_after=after)
    if after > before + (64 << 20):
        raise RuntimeError(f"phase 15 left {after - before} bytes allocated")
    out["phase_s"] = time.perf_counter() - t_phase
    results["moe"] = out
    log(f"[moe] (f) model freed: {after} bytes allocated (before the phase "
        f"{before}); phase 15 in {out['phase_s']:.3f} s ((a) "
        f"{out['reduced']['s']:.3f} s; "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["step_s"].items())
        + " s)")


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


def grouped_flush(results: dict, err: dict) -> dict:
    """digest_sig as one grouped launch over phase 5's first flush (the
    first records of shard 0, up to the build's flush limits), held
    against the plain version entry by entry and timed beside it."""
    staging, table, words = results.pop("flush_group")
    x = staging.cuda()
    got = torch.empty(words, dtype=torch.int32, device="cuda")
    want = torch.empty_like(got)

    def kernel():
        ds.digest_sig_group(x, table, got, n=4)

    def plain():
        for e, views in zip(table, ds.group_views(want, table)):
            rows, width = int(e["rows"]), int(e["width"])
            off = int(e["in_off"])
            mat = x[off:off + rows * (width + PAD)].reshape(rows, -1)
            for dst, src in zip(views, ds.digest_sig_plain(
                    mat, n=4, block=int(e["kblock"]))):
                dst.copy_(src)

    kernel()
    plain()
    torch.cuda.synchronize()
    d = max(int((g.long() - w.long()).abs().max())
            for gv, wv in zip(ds.group_views(got, table),
                              ds.group_views(want, table))
            for g, w in zip(gv, wv))
    if d:
        raise RuntimeError(f"digest_sig grouped over a build flush: max "
                           f"|kernel - plain| = {d}")
    err["digest_sig"] = max(err["digest_sig"], d)
    ms = time_ms(kernel)
    pms = time_ms(plain, 20)
    nbytes = ops = 0
    for e in table:
        b, o = digest_cost(int(e["rows"]), int(e["width"]),
                           int(e["kblock"]), 4)
        nbytes, ops = nbytes + b, ops + o
    bnd, by = bound(nbytes, ops)
    shapes = [[int(e["rows"]), int(e["width"]) + PAD] for e in table]
    log(f"[kernels] digest_sig grouped over phase 5's first flush "
        f"({len(table)} buckets, {int(table['rows'].sum())} padded rows, "
        f"{nbytes} bytes): {ms:.4g} ms/launch, bound {bnd:.4g} ms ({by}), "
        f"plain {pms:.4g} ms; == plain")
    return {"ms": ms, "plain_ms": pms, "bound_ms": bnd, "bound_by": by,
            "bytes": nbytes, "buckets": shapes, "max_abs_err": d}


def same_pattern(kernel, plain):
    """``make`` for :func:`worst_case`: the per-row-pattern scan ``kernel``
    and its plain version over ``x`` with the 16-byte ``p`` on every row,
    their tensors made once on the card."""
    def make(x: torch.Tensor, p: np.ndarray):
        pt = torch.from_numpy(np.tile(p, (x.shape[0], 1))).cuda()
        nt = torch.full((x.shape[0],), 16, dtype=torch.int32, device="cuda")
        return (lambda: kernel(x, pt, nt, 16), lambda: plain(x, pt, nt, 16))
    return make


def short_case(name: str, kernel, plain, x: torch.Tensor, p: torch.Tensor,
               n: torch.Tensor, tail: int, err: dict) -> dict:
    """A per-row-pattern scan with ``short_lens(n)`` and max_len 16 (its
    loop stops at each row's own length): held against its plain version
    and timed, with the bound of the lengths it compares."""
    short = short_lens(n)
    err[name] = max(err[name], timed_err(
        f"{name} with lens[r] < max_len", lambda: kernel(x, p, short, 16),
        lambda: plain(x, p, short, 16)))
    return {"ms": time_ms(lambda: kernel(x, p, short, 16)),
            "bound_ms": bound(*multi_cost(
                x.shape[0], x.shape[1] - tail, tail,
                np.clip(short.cpu().numpy(), 1, 16)))[0],
            "lens": "three rows in four at most 2, rows 1-3 0, -3, 40; "
                    "max_len 16"}


def worst_case(name: str, make, rows: int, width: int, tail: int,
               err: dict) -> dict:
    """An early-exit scan at (rows, W + tail) on the inputs where its early
    exit never fires: ``make(x, p)`` gives the kernel's call and its plain
    version's, held against each other and timed; ``ms`` is the slower
    input's."""
    out = {}
    for label, (m, p) in zip(("a x 16", "pattern repeated"),
                             worst_case_inputs(rows, width, tail)):
        x = torch.from_numpy(m).cuda()
        run, plain = make(x, p)
        err[name] = max(err[name], timed_err(f"{name} worst case", run,
                                             plain))
        out[label] = {"ms": time_ms(run)}
    return {"ms": max(c["ms"] for c in out.values()),
            "shape": [rows, width + tail], "cases": out}


def grouped_scan_call(name: str, call: tuple, err: dict) -> dict:
    """pattern_scan_batch (``name`` "pattern_scan") or
    pattern_scan_batch_multi as one grouped launch over the width buckets
    of a real call of phase 6 or 10, packed as its wrapper packs it, held
    against the plain version entry by entry and timed beside it."""
    from repro_torch.kernels.bucketing import as_u8
    from repro_torch.kernels.pattern_scan.ops import _check_pattern, pack_scan

    bufs, args, block = call
    arrs = [as_u8(b) for b in bufs]
    multi = name != "pattern_scan"
    if multi:
        vecs, plens = zip(*(_check_pattern(p) for p in args[0]))
        staging, table, nmask, _ = pack_scan(
            arrs, block, patterns=list(vecs), plens=list(plens), pin=True)
    else:
        vec, plen = _check_pattern(args[0])
        staging, table, nmask, _ = pack_scan(arrs, block, pin=True)
    x = staging.cuda()
    got = torch.empty(nmask, dtype=torch.uint8, device="cuda")
    want = torch.empty_like(got)

    def entry_inputs(e):
        rows, width = int(e["rows"]), int(e["width"])
        off = int(e["in_off"])
        mat = x[off:off + rows * (width + 16)].reshape(rows, -1)
        if not multi:
            return (mat,)
        poff, loff = int(e["pat_off"]), int(e["len_off"])
        return (mat, x[poff:poff + 16 * rows].reshape(rows, 16),
                x[loff:loff + 4 * rows].view(torch.int32))

    def kernel():
        if multi:
            ps.pattern_scan_multi_group(x, table, got)
        else:
            ps.pattern_scan_group(x, table, got, vec, plen)

    def plain():
        for e, out in zip(table, ps.group_views(want, table)):
            if multi:
                out.copy_(ps.pattern_scan_multi_plain(*entry_inputs(e),
                                                      int(e["max_len"])))
            else:
                out.copy_(ps.pattern_scan_plain(*entry_inputs(e), vec, plen))

    before = ps.multi_launches if multi else ps.launches
    kernel()
    after = ps.multi_launches if multi else ps.launches
    plain()
    torch.cuda.synchronize()
    d = max(int((g.int() - w.int()).abs().max())
            for g, w in zip(ps.group_views(got, table),
                            ps.group_views(want, table)))
    if d or after != before + 1:
        raise RuntimeError(f"{name} grouped over a real call: max |kernel - "
                           f"plain| = {d}, {after - before} launches")
    err[name] = max(err[name], d)
    ms = time_ms(kernel)
    pms = time_ms(plain, 20)
    nbytes = ops = 0
    for e in table:
        rows, width = int(e["rows"]), int(e["width"])
        b, o = (multi_cost(rows, width, 16, entry_inputs(e)[2].cpu().numpy())
                if multi else scan_cost(rows, width, plen))
        nbytes, ops = nbytes + b, ops + o
    bnd, by = bound(nbytes, ops)
    shapes = [[int(e["rows"]), int(e["width"]) + 16] for e in table]
    log(f"[kernels] {name} grouped over a real call ({len(table)} buckets, "
        f"{int(table['rows'].sum())} padded rows, {nbytes} bytes): {ms:.4g} "
        f"ms/launch, bound {bnd:.4g} ms ({by}), plain {pms:.4g} ms; == plain")
    return {"ms": ms, "plain_ms": pms, "bound_ms": bnd, "bound_by": by,
            "bytes": nbytes, "buckets": shapes, "max_abs_err": d}


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
    ms_read = time_ms_read_flush(lambda: ps.pattern_scan_batch(x, pat, 16))
    plain = time_ms(lambda: ps.pattern_scan_plain(x, pat, 16), 20)
    b_scan, by_scan = bound(*scan_cost(rows, width, 16))
    s_worst = worst_case(
        "pattern_scan", lambda xw, p: (
            lambda: ps.pattern_scan_batch(xw, p, 16),
            lambda: ps.pattern_scan_plain(xw, p, 16)),
        rows, width, 16, err)
    s_grouped = grouped_scan_call("pattern_scan", results.pop("scan_call"),
                                  err)
    log(f"[kernels] pattern_scan at its dominant shape ({rows} x "
        f"{width + 16}, P=16): {ms:.4g} ms (read flush {ms_read:.4g}), "
        f"bound {b_scan:.4g} ms; worst case {s_worst['ms']:.4g} ms")
    drows, dwidth = results["digest_sig_shape"]
    kblock = min(ds.BLOCK, dwidth)
    y = digest_inputs(rng, drows, dwidth)
    agree("digest_sig", lambda: ds.digest_sig_partials_batch(
        y, n=4, block=kblock), lambda: ds.digest_sig_plain(
        y, n=4, block=kblock))
    dms = time_ms(lambda: ds.digest_sig_partials_batch(y, n=4, block=kblock))
    dms_read = time_ms_read_flush(lambda: ds.digest_sig_partials_batch(
        y, n=4, block=kblock))
    dplain = time_ms(lambda: ds.digest_sig_plain(y, n=4, block=kblock), 20)
    b_dig, by_dig = bound(*digest_cost(drows, dwidth, kblock, 4))
    grouped = grouped_flush(results, err)
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
    gms_read = time_ms_read_flush(
        lambda: ps.pattern_scan_rowgroup(z, zpat, 16))
    gplain = time_ms(lambda: ps.pattern_scan_rowgroup_plain(z, zpat, 16), 20)
    b_grp, by_grp = bound(*rowgroup_cost(lens.size, gwidth, 16))
    worst = worst_case(
        "pattern_scan_rowgroup", lambda xw, p: (
            lambda: ps.pattern_scan_rowgroup(xw, p, 16),
            lambda: ps.pattern_scan_rowgroup_plain(xw, p, 16)),
        int(lens.size), gwidth, PAD, err)
    log(f"[kernels] pattern_scan_rowgroup at the store's shape "
        f"({lens.size} x {gwidth + PAD}, P=16): {gms:.4g} ms (read flush "
        f"{gms_read:.4g}), bound {b_grp:.4g} ms; worst case "
        f"{worst['ms']:.4g} ms")
    floor = floor_numbers({
        "pattern_scan": scan_cost(rows, width, 16)[0],
        "digest_sig": digest_cost(drows, dwidth, kblock, 4)[0],
        "pattern_scan_rowgroup": rowgroup_cost(lens.size, gwidth, 16)[0]})
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
    m_worst = worst_case("pattern_scan_batch_multi", same_pattern(
        ps.pattern_scan_batch_multi, ps.pattern_scan_multi_plain),
        mrows, mwidth, 16, err)
    m_short = short_case("pattern_scan_batch_multi",
                         ps.pattern_scan_batch_multi,
                         ps.pattern_scan_multi_plain, mx, mp, mn, 16, err)
    m_grouped = grouped_scan_call("pattern_scan_batch_multi",
                                  results.pop("gateway_chunk"), err)
    log(f"[kernels] pattern_scan_batch_multi at its dominant shape ({mrows} "
        f"x {mwidth + 16}, P=1..16): {mms:.4g} ms, bound {b_mul:.4g} ms; "
        f"worst case {m_worst['ms']:.4g} ms; lens[r] < max_len on most rows "
        f"{m_short['ms']:.4g} ms")
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
    r_worst = worst_case("pattern_scan_rowgroup_multi", same_pattern(
        ps.pattern_scan_rowgroup_multi, ps.pattern_scan_rowgroup_multi_plain),
        grows, gwidth, PAD, err)
    r_short = short_case("pattern_scan_rowgroup_multi",
                         ps.pattern_scan_rowgroup_multi,
                         ps.pattern_scan_rowgroup_multi_plain, gx, gp_t, gn_t,
                         PAD, err)
    log(f"[kernels] pattern_scan_rowgroup_multi on phase 10's row-group "
        f"({grows} x {gwidth + PAD}, {len(pats)} patterns): {rms:.4g} ms, "
        f"bound {b_rmul:.4g} ms, plain {rplain:.4g} ms; worst case "
        f"{r_worst['ms']:.4g} ms; lens[r] < max_len on most rows "
        f"{r_short['ms']:.4g} ms")
    # adler32 at verify's dominant width bucket
    arows, awidth = results["adler32_shape"]
    ax = adler_inputs(rng, arows, awidth)
    agree("adler32", lambda: ad.adler32_partials_batch(ax),
          lambda: ad.adler32_plain(ax))
    ams = time_ms(lambda: ad.adler32_partials_batch(ax))
    aplain = time_ms(lambda: ad.adler32_plain(ax), 20)
    b_ad, by_ad = bound(*adler_cost(arows, awidth))
    # flash_attention: phase 4's prefill case heads the entry, every case
    # beside it, each checked on the inputs it was timed on
    fl = results["flash"]["prefill"]
    bw = results["attention_backward"]["train_1k"]
    codec = results["codecs"]["launches"]
    return {"floor": floor, "kernels": [
        {"name": "pattern_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/pattern_scan/csrc/pattern_scan.cu",
         "replaces": "src/repro/kernels/pattern_scan/pattern_scan.py:122",
         "launches": (results["pattern_scan_launches"]
                      + codec["pattern_scan (search)"]),
         "launches_by_phase": {
             "serve": results["pattern_scan_launches"],
             "codecs search": codec["pattern_scan (search)"]},
         "max_abs_err": err["pattern_scan"],
         "ms": ms, "plain_ms": plain, "bound_ms": b_scan,
         "bound_by": by_scan, "library_ms": None,
         "shape": [rows, width + 16], "pattern_len": 16,
         "ms_read_flush": ms_read,
         "worst_case": s_worst, "grouped": s_grouped,
         "kernel_path_calls": results["serve"]["kernel_path_batches"],
         "width_buckets": results["serve"]["width_buckets"]},
        {"name": "digest_sig", "route": "cuda",
         "source": "src/repro_torch/kernels/digest_sig/csrc/digest_sig.cu",
         "replaces": "src/repro/kernels/digest_sig/digest_sig.py:84",
         "launches": (results["digest_sig_launches"]
                      + results["derive_digest_sig_launches"]
                      + results["verify_digest_sig_launches"]
                      + results["pool_digest_sig_launches"]
                      + results["pool_derive_digest_sig_launches"]
                      + codec["digest_sig (build)"]
                      + codec["digest_sig (derive)"]
                      + codec["digest_sig (tolerant build)"]),
         "max_abs_err": err["digest_sig"],
         "ms": dms, "plain_ms": dplain, "bound_ms": b_dig,
         "bound_by": by_dig, "library_ms": None,
         "shape": [drows, dwidth + 128], "ms_read_flush": dms_read,
         "grouped": grouped,
         "launches_by_phase": {
             "build": results["digest_sig_launches"],
             "derive": results["derive_digest_sig_launches"],
             "verify": results["verify_digest_sig_launches"],
             "pool build (in the workers)":
                 results["pool_digest_sig_launches"],
             "pool derive": results["pool_derive_digest_sig_launches"],
             "codecs build": codec["digest_sig (build)"],
             "codecs derive": codec["digest_sig (derive)"],
             "codecs tolerant build": codec["digest_sig (tolerant build)"]}},
        {"name": "pattern_scan_rowgroup", "route": "cuda",
         "source": "src/repro_torch/kernels/pattern_scan/csrc/pattern_scan.cu",
         "replaces": "src/repro/kernels/pattern_scan/pattern_scan.py:185",
         "launches": (results["rowgroup_launches"]
                      + codec["pattern_scan_rowgroup (columnar search)"]),
         "launches_by_phase": {
             "columnar serve": results["rowgroup_launches"],
             "codecs columnar search":
                 codec["pattern_scan_rowgroup (columnar search)"]},
         "max_abs_err": err["pattern_scan_rowgroup"],
         "ms": gms, "plain_ms": gplain, "bound_ms": b_grp,
         "bound_by": by_grp, "library_ms": None,
         "shape": [int(lens.size), gwidth + PAD], "pattern_len": 16,
         "ms_read_flush": gms_read,
         "worst_case": worst},
        {"name": "pattern_scan_batch_multi", "route": "cuda",
         "source": "src/repro_torch/kernels/pattern_scan/csrc/pattern_scan.cu",
         "replaces": "src/repro/kernels/pattern_scan/pattern_scan.py:84",
         "launches": results["multi_launches"],
         "max_abs_err": err["pattern_scan_batch_multi"],
         "ms": mms, "plain_ms": mplain, "bound_ms": b_mul,
         "bound_by": by_mul, "library_ms": None,
         "shape": [mrows, mwidth + 16], "pattern_lens": "1..16",
         "worst_case": m_worst, "short_lens": m_short,
         "grouped": m_grouped,
         "kernel_dispatch_spans":
             results["gateway"]["kernel_dispatch_spans"],
         "width_buckets": results["gateway"]["metrics"]["kernel_dispatches"]},
        {"name": "pattern_scan_rowgroup_multi", "route": "cuda",
         "source": "src/repro_torch/kernels/pattern_scan/csrc/pattern_scan.cu",
         "replaces": "src/repro/kernels/pattern_scan/pattern_scan.py:216",
         "launches": results["rowgroup_multi_launches"],
         "max_abs_err": err["pattern_scan_rowgroup_multi"],
         "ms": rms, "plain_ms": rplain, "bound_ms": b_rmul,
         "bound_by": by_rmul, "library_ms": None,
         "shape": [grows, gwidth + PAD],
         "pattern_lens": sorted({len(p) for p in pats}),
         "worst_case": r_worst, "short_lens": r_short},
        {"name": "adler32", "route": "cuda",
         "source": "src/repro_torch/kernels/adler32/csrc/adler32.cu",
         "replaces": "src/repro/kernels/adler32/adler32.py:51",
         "launches": (results["adler32_launches"]
                      + codec["adler32 (verify)"]),
         "launches_by_phase": {
             "verify": results["adler32_launches"],
             "codecs verify": codec["adler32 (verify)"]},
         "max_abs_err": err["adler32"],
         "ms": ams, "plain_ms": aplain, "bound_ms": b_ad,
         "bound_by": by_ad, "library_ms": None,
         "shape": [arows, awidth]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:93",
         "launches": (results["flash_launches"]
                      + results["train"]["launches"]["flash_attention"]
                      + sum(results["moe"]["flash_launches"].values())),
         "max_abs_err": err["flash_attention"],
         "ms": fl["ms"], "plain_ms": fl["plain_ms"],
         "bound_ms": fl["bound_ms"], "bound_by": fl["bound_by"],
         "library_ms": fl["library_ms"],
         "library": "scaled_dot_product_attention(is_causal=True, "
                    "enable_gqa=True)",
         "shape": [fl["shape_q"], fl["shape_kv"]], "dtype": "float32",
         "max_abs_err_bf16": err["flash_attention_bf16"],
         "launches_by_phase": {
             **results["lm"]["flash_launches"],
             "train_lm": results["train"]["launches"]["flash_attention"],
             **results["moe"]["flash_launches"]},
         "train_1k_lse_ms": bw["fwd_lse_ms"],
         "launches_by_path": {
             phase: results["moe"]["flash_paths"][phase]
             for phase in ("moe prefill", "moe engine")},
         "cases": {label: {k: c[k] for k in (
             "shape_q", "shape_kv", "dtype", "causal", "path", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms",
             "max_abs_err")}
             for label, c in results["flash"].items()}},
        {"name": "flash_attention_backward", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_bwd.cu",
         "replaces": "src/repro/models/attention.py:51 (no Pallas kernel: "
                     "XLA's gradient of chunked_attention)",
         "launches": results["train"]["launches"]["flash_attention_backward"],
         "cuda_launches": results["train"]["launches"][
             "flash_attention_backward (CUDA launches)"],
         "max_abs_err": err["flash_attention_backward"],
         "ms": bw["ms"], "plain_ms": bw["plain_ms"],
         "bound_ms": bw["bound_ms"], "bound_by": bw["bound_by"],
         "library_ms": bw["library_ms"],
         "library": "backward of scaled_dot_product_attention(is_causal="
                    "True, enable_gqa=True)",
         "shape": [bw["shape_q"], bw["shape_kv"]], "dtype": "float32",
         "cases": {label: {k: c[k] for k in (
             "shape_q", "shape_kv", "causal", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms", "max_abs_err")}
             for label, c in results["attention_backward"].items()}},
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
        entry = ""
        for line in _build.build_log(stem).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            elif "registers" in line or "spill" in line:
                log(f"[build-kernels] {stem} {entry}: "
                    f"{line.split('ptxas info    :')[-1].strip()}")

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
    try:
        pool_phase(paths, workdir, index, results)
    finally:
        stop_mp_helpers()
    gateway_phase(index, checked, results)
    rowgroup_multi_phase(store, results)
    lm_phase(paths, results)
    try:
        train_phase(paths, workdir, results)
    finally:
        stop_mp_helpers()
    codec_phase(workdir, results)
    moe_phase(paths, results)
    codec = results["codecs"]["launches"]

    launches = {"digest_sig (build)": results["digest_sig_launches"],
                "pattern_scan (serve)": results["pattern_scan_launches"],
                "digest_sig (derive)": results["derive_digest_sig_launches"],
                "pattern_scan_rowgroup (columnar serve)":
                    results["rowgroup_launches"],
                "adler32 (verify)": results["adler32_launches"],
                "digest_sig (verify, check_signatures)":
                    results["verify_digest_sig_launches"],
                "digest_sig (pool build, in the workers)":
                    results["pool_digest_sig_launches"],
                "digest_sig (pool derive)":
                    results["pool_derive_digest_sig_launches"],
                "pattern_scan_batch_multi (gateway)":
                    results["multi_launches"],
                "pattern_scan_rowgroup_multi (row-group check)":
                    results["rowgroup_multi_launches"],
                "flash_attention (LM prefill)":
                    results["lm"]["flash_launches"]["prefill"],
                "flash_attention (LM engine)":
                    results["lm"]["flash_launches"]["engine"],
                "flash_attention (train_lm)":
                    results["train"]["launches"]["flash_attention"],
                "flash_attention (MoE prefill)":
                    results["moe"]["flash_launches"]["moe prefill"],
                "flash_attention (MoE engine)":
                    results["moe"]["flash_launches"]["moe engine"],
                "flash_attention_backward (train_lm)":
                    results["train"]["launches"]["flash_attention_backward"],
                **{f"{k}, codecs": v for k, v in codec.items()}}
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
    stop_mp_helpers()
    print(json.dumps(line), flush=True)
    print(device_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
