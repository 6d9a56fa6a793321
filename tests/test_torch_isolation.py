"""``repro_torch`` and ``chip_smoke.py`` run without JAX and without the
reference package (index build, CDX search, columnar derive and search,
index verification, the sharded gateway, LM forward and serving (dense
and MoE), the process pool — in its forked and its spawned workers
too — the codec slice: LZ4 and zstd shards, the decoder child process,
tolerant parsing and the WARCIO baseline — and the training slice:
packing, the text pipeline, the token loader serial and with pool
workers, attention's gradient, the microbatched step with gradient
compression, checkpoints and ``train_lm`` with a resume); every path but
zstd's also runs without ``zstandard``; and the port's entry points
default to the GPU."""
import ast
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# the port's code in scan units: each subpackage, and the package's
# top-level modules together with chip_smoke.py
SUBPACKAGES = ["columnar", "core", "data", "index", "kernels", "obs"]
# subpackages scanned with another unit: the gateway serves the index;
# the LM stack (models, configs) runs the attention kernel; checkpoint
# restore and the serving CLI read data from disk; the fault injectors
# drive the process pool
ALSO_SCANNED = {"index": ["serve"], "kernels": ["models", "configs"],
                "data": ["train", "launch"], "core": ["testing"]}

# a script file, not ``-c``: spawned pool workers re-import it, so the
# import blocker (module level) is installed in every child too; the
# run itself is the body of its ``__main__`` block
_BLOCKER = r"""
import importlib.abc, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.modules["jax"] = None
sys.meta_path.insert(0, _Block())
sys.path.insert(0, sys.argv[1] + "/src")
sys.path.insert(0, sys.argv[1])


def _blocked_in_child(path):
    # runs in a spawned pool worker: build a one-shard index there, and
    # report whether jax and repro are still blocked and absent
    from repro_torch.index import build_index
    blocked = []
    for name in ("jax", "repro"):
        try:
            __import__(name)
        except ImportError:
            blocked.append(name)
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")
              and sys.modules[m] is not None]
    return len(build_index([path], device="cpu")), blocked, loaded
"""

_BLOCKED_BODY = r"""
import tempfile
import chip_smoke  # module-level code only: main() needs a GPU
from repro_torch.data.synth import CorpusSpec, write_corpus
from repro_torch.index import (IndexQueryService, QueryRequest, build_index,
                               full_scan_search)
d = tempfile.mkdtemp()
paths = [f"{d}/s{i}.warc.gz" for i in range(2)]
for i, p in enumerate(paths):
    write_corpus(p, CorpusSpec(n_pages=3, seed=i), "gzip")
index = build_index(paths, device="cpu")
with IndexQueryService(index, device="cpu") as svc:
    (resp,) = svc.serve([QueryRequest(b"nginx/1.", top_k=100)])
got = {(h.shard, h.offset): h.n_matches for h in resp.hits}
assert got == full_scan_search(paths, b"nginx/1.") and got
# the columnar slice: derive a store, serve through a store-backed engine
from repro_torch.columnar import derive
from repro_torch.index import QueryEngine
store = derive(paths, f"{d}/c.repcol", device="cpu")
engine = QueryEngine.from_store(store, device="cpu")
with IndexQueryService(engine.index, engine=engine) as svc:
    (resp,) = svc.serve([QueryRequest(b"nginx/1.", top_k=100)])
assert {(h.shard, h.offset): h.n_matches for h in resp.hits} == got
assert engine.stats["kernel_dispatches"] > 0
# the verify slice: every digest and signature checks out
from repro_torch.core.warc.checksum import verify_digests_bulk
from repro_torch.index import verify_index
assert verify_index(index, device="cpu") == [True] * len(index)
assert all(verify_index(index, check_signatures=True, device="cpu"))
assert verify_digests_bulk([b"a", b"a"], ["adler32:00620062", "crc32:0"],
                           device="cpu") == [True, False]
# the gateway: two shards, coalesced duplicates, the same hits
from repro_torch.serve import ArchiveGateway
with ArchiveGateway(index, shards=2, device="cpu") as gw:
    futs = [gw.submit(QueryRequest(b"nginx/1.", top_k=100))
            for _ in range(3)]
    for f in futs:
        assert {(h.shard, h.offset): h.n_matches
                for h in f.result(60).hits} == got
    assert gw.metrics.count("kernel_dispatches") > 0
# the LM slice: a reduced forward and the serving engine
import numpy as np
import torch
from repro_torch.configs import get_spec
from repro_torch.models import transformer as tf
from repro_torch.serve import Request, ServeEngine
cfg = get_spec("fastwarc_lm").reduced
params = tf.init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
logits, _ = tf.forward(params, np.ones((2, 8), np.int64), cfg)
assert logits.shape == (2, 8, cfg.vocab) and bool(torch.isfinite(logits).all())
engine = ServeEngine(cfg, params, batch_size=2, max_seq=32, device="cpu")
done = engine.serve([Request(b"web", max_new_tokens=3), Request(b"x", 2)])
assert [len(r.out_tokens) for r in done] == [3, 2] and all(r.done for r in done)
# the MoE slice: the four configs it added, the reduced Qwen3-MoE forward
# and engine, and the dispatch against its plain version
from repro_torch.models import moe
assert [get_spec(a).config.param_count() for a in (
    "qwen3_moe_30b_a3b", "qwen3_moe_235b_a22b", "starcoder2_3b",
    "qwen25_32b")] == [30532110336, 235093610496, 4312980480, 32763876352]
mcfg = get_spec("qwen3_moe_30b_a3b").reduced
mp = tf.init_params(mcfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
logits, aux = tf.forward(mp, np.ones((2, 8), np.int64), mcfg)
assert logits.shape == (2, 8, mcfg.vocab) and float(aux) > 0
hid = torch.randn(24, mcfg.d_model)
got = moe.moe_apply(mp.layers[0].moe, hid, top_k=2, capacity_factor=0.5)
want = moe.moe_apply_plain(mp.layers[0].moe, hid, top_k=2,
                           capacity_factor=0.5)
assert all(torch.allclose(a, b, atol=1e-6) for a, b in zip(got, want[:2]))
done = ServeEngine(mcfg, mp, batch_size=2, max_seq=32, device="cpu").serve(
    [Request(b"web", max_new_tokens=3)])
assert done[0].done and 0 < len(done[0].out_tokens) <= 3
# the codec slice: LZ4 and zstd shards through build, verify and
# derive, a tolerant build of a damaged shard, the decoder child process
# and the WARCIO baseline
from repro_torch import obs
from repro_torch.core.warc import FastWARCIterator, WARCIOArchiveIterator
from repro_torch.testing.faults import corrupt_warc
mixed = [f"{d}/m.{comp}" for comp in ("lz4", "zstd")]
for p, comp in zip(mixed, ("lz4", "zstd")):
    write_corpus(p, CorpusSpec(n_pages=3, seed=0), comp)
mi = build_index(mixed, device="cpu")
assert np.array_equal(mi.digest, np.concatenate([index.digest[:10]] * 2))
assert mi.frame_hint(15) is not None and verify_index(mi, device="cpu") \
    == [True] * 20
derive(mixed, f"{d}/m.repcol", device="cpu").close()
with open(paths[0], "rb") as f:
    bad, spans = corrupt_warc(f.read(), fraction=0.2, seed=0)
with open(f"{d}/bad.warc.gz", "wb") as f:
    f.write(bad)
ti = build_index([f"{d}/bad.warc.gz"], tolerant=True, device="cpu")
assert ti.errors and len(ti) == 10 - len(spans), (ti.errors, spans)
obs.reset()
assert sum(1 for _ in FastWARCIterator(mixed[0])) == 10
assert obs.snapshot().counter("ingest.readahead.process") == 1
assert len(list(WARCIOArchiveIterator(paths[0]))) == 10
# the process pool, its reaper, stats slots and fault injection: forked
# workers for build and derive, spawned ones for map_shards
import repro_torch.core.reaper, repro_torch.obs.shmstats
from repro_torch.core.parallel import map_shards
from repro_torch.testing.faults import arm_worker_kill
pooled = build_index(paths, workers=2, device="cpu")
assert np.array_equal(pooled.signatures, index.signatures)
pooled_store = derive(paths, f"{d}/p.repcol", workers=2, device="cpu")
assert len(pooled_store) == len(index)
pooled_store.close()
kids = map_shards(_blocked_in_child, paths, workers=2, mp_context="spawn")
assert [k[0] for k in kids] == [10, 10], kids
assert all(k[1:] == (["jax", "repro"], []) for k in kids), kids
# the training slice: the text pipeline and the token loader (serial
# and with forked pool workers), attention's gradient, a microbatched
# step with gradient compression, checkpoints, and train_lm with a resume
from repro_torch.core.parallel import iter_documents_parallel
from repro_torch.core.pipeline import iter_documents, web_graph_from_warcs
from repro_torch.data.loader import WarcTokenLoader
from repro_torch.data.packing import SequencePacker, pad_batch
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.train import train_lm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step
docs = [x.text for p in paths for x in iter_documents(p, min_length=0)]
assert docs and docs == [x.text for x in iter_documents_parallel(
    paths, workers=2, ordered=True, min_length=0)]
assert web_graph_from_warcs(paths, workers=2)["hosts"]
assert pad_batch(SequencePacker(4).feed(np.arange(9)), 3, 4).shape == (3, 5)
loaders = [WarcTokenLoader(paths, batch=2, seq_len=16, prefetch=0,
                           min_doc_len=0, workers=w) for w in (0, 2)]
batches = [[next(g).copy() for _ in range(3)]
           for g in (ld.batches() for ld in loaders)]
assert all(np.array_equal(a, b) for a, b in zip(*batches))
for ld in loaders:
    ld.close()
q = torch.randn(1, 4, 8, 32, requires_grad=True)
kv = torch.randn(1, 2, 8, 32)
(g,) = torch.autograd.grad(flash_attention(q, kv, kv).sum(), (q,))
assert g.shape == q.shape and bool(torch.isfinite(g).all())
state = init_train_state(params, use_grad_compression=True)
step = make_train_step(
    lambda p, b: tf.loss_fn(p, b["tokens"], b["labels"], cfg),
    AdamWConfig(), n_microbatches=2, use_grad_compression=True)
tokens = np.ones((2, 9), np.int32)
state, metrics = step(state, {"tokens": tokens[:, :-1],
                              "labels": tokens[:, 1:]})
ckpt.save(f"{d}/ck", 1, state, extras={"step": 1})
state, extras = ckpt.restore(f"{d}/ck", state)
assert extras == {"step": 1} and state["opt"]["step"] == 1
kw = dict(shards=paths, batch=2, seq_len=16, reduced=True, ckpt_every=1,
          device="cpu", ckpt_dir=f"{d}/run")
assert train_lm(steps=1, **kw)["steps"] == 1
assert train_lm(steps=2, **kw)["steps"] == 2
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")
       and sys.modules[m] is not None]
assert not bad, bad
print("ISOLATED-OK", len(index))
"""
_BLOCKED_RUN = (_BLOCKER + 'if __name__ == "__main__":\n'
                + textwrap.indent(_BLOCKED_BODY, "    "))


_NO_ZSTD_BODY = r"""
import tempfile
from repro_torch import obs
from repro_torch.columnar import derive
from repro_torch.core.warc import (FastWARCIterator, WARCIOArchiveIterator,
                                   WarcWriter)
from repro_torch.data.synth import CorpusSpec, write_corpus
from repro_torch.index import build_index, verify_index
from repro_torch.testing.faults import corrupt_warc
d = tempfile.mkdtemp()
paths = [f"{d}/s.{comp}" for comp in ("none", "gzip", "lz4")]
for p, comp in zip(paths, ("none", "gzip", "lz4")):
    write_corpus(p, CorpusSpec(n_pages=3, seed=0), comp)
index = build_index(paths, device="cpu")
assert len(index) == 30 and all(verify_index(index, device="cpu"))
derive(paths, f"{d}/c.repcol", device="cpu").close()
with open(paths[2], "rb") as f:
    bad, spans = corrupt_warc(f.read(), fraction=0.2, seed=0)
with open(f"{d}/bad.lz4", "wb") as f:
    f.write(bad)
ti = build_index([f"{d}/bad.lz4"], tolerant=True, device="cpu")
assert ti.errors and len(ti) == 10 - len(spans)
obs.reset()
assert sum(1 for _ in FastWARCIterator(paths[1])) == 10
assert obs.snapshot().counter("ingest.readahead.process") == 1
assert len(list(WARCIOArchiveIterator(paths[1]))) == 10
# zstd needs the package, and says so
for call in (lambda: WarcWriter(open(f"{d}/z", "wb"), "zstd"),
             lambda: list(FastWARCIterator(sys.argv[2]))):
    try:
        call()
    except RuntimeError as exc:
        assert "zstandard" in str(exc), exc
    else:
        raise AssertionError("zstd ran without zstandard")
assert "zstandard" not in sys.modules or sys.modules["zstandard"] is None
print("NO-ZSTD-OK", len(index))
"""
_NO_ZSTD_RUN = (_BLOCKER.replace('("jax", "jaxlib", "repro")',
                                 '("jax", "jaxlib", "repro", "zstandard")')
                .replace('sys.modules["jax"] = None',
                         'sys.modules["jax"] = sys.modules["zstandard"] = None')
                + 'if __name__ == "__main__":\n'
                + textwrap.indent(_NO_ZSTD_BODY, "    "))


def test_port_runs_without_zstandard(tmp_path):
    """Every path but zstd's runs where ``zstandard`` cannot be imported
    (the card's machine is not known to have it)."""
    from repro_torch.data.synth import CorpusSpec, write_corpus

    pytest.importorskip("zstandard")
    zpath = str(tmp_path / "a.zstd")
    write_corpus(zpath, CorpusSpec(n_pages=1), "zstd")
    assert _NO_ZSTD_RUN.count('"zstandard"') >= 2
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    script = tmp_path / "no_zstd_run.py"
    script.write_text(_NO_ZSTD_RUN)
    out = subprocess.run([sys.executable, str(script), str(ROOT), zpath],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO-ZSTD-OK 30" in out.stdout


def test_port_runs_with_jax_and_reference_blocked(tmp_path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    script = tmp_path / "blocked_run.py"
    script.write_text(_BLOCKED_RUN)
    out = subprocess.run([sys.executable, str(script), str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED-OK 20" in out.stdout


def _unit_files(unit: str) -> list[Path]:
    if unit == "top-level":
        return sorted(PORT.glob("*.py")) + [ROOT / "chip_smoke.py"]
    return [p for sub in [unit, *ALSO_SCANNED.get(unit, [])]
            for p in sorted((PORT / sub).rglob("*.py"))]


@pytest.mark.parametrize("unit", SUBPACKAGES + ["top-level"])
def test_no_jax_or_reference_imports(unit):
    files = _unit_files(unit)
    if unit == "top-level":  # every subpackage is one of the scan units
        assert sorted(p.name for p in PORT.iterdir() if p.is_dir()
                      and p.name != "__pycache__") == sorted(
            SUBPACKAGES + [s for v in ALSO_SCANNED.values() for s in v])
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"
                    for name in names
                    if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert files and not bad, bad


def _default_device_calls(entry: str, path: str) -> list:
    """Calls that must raise without a GPU unless ``device="cpu"`` is
    given; each parametrised entry also covers later slices' entry
    points of the same kind."""
    from repro_torch import resolve_device
    from repro_torch.core.warc.checksum import verify_digests_bulk
    from repro_torch.index import (IndexQueryService, QueryEngine,
                                   build_index, verify_index)
    from repro_torch.kernels.adler32 import adler32_batch
    from repro_torch.kernels.digest_sig import digest_signature_batch
    from repro_torch.kernels.pattern_scan import (
        find_pattern_mask_batch, find_pattern_masks_multi,
        find_pattern_masks_multi_rowgroup)
    from repro_torch.configs import get_spec
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer as tf
    from repro_torch.serve import ArchiveGateway, ServeEngine

    cfg = get_spec("fastwarc_lm").reduced
    gen = torch.Generator().manual_seed(0)

    def cuda_default(shape):  # a tensor on the port's default device
        return torch.zeros(shape, device=resolve_device("cuda"))

    if entry == "build_index":
        from repro_torch.launch.train import train_lm

        return [lambda: build_index([path]),
                lambda: tf.init_params(cfg, generator=gen),
                lambda: tf.init_params(get_spec("qwen3_moe_30b_a3b").reduced,
                                       generator=gen),
                lambda: tf.init_cache(cfg, 1, 8),
                lambda: train_lm(shards=[path], steps=1)]
    params = tf.init_params(cfg, generator=gen, device="cpu")
    index = build_index([path], device="cpu")
    group = np.zeros((2, 16 + 128), np.uint8)
    return {"QueryEngine": [lambda: QueryEngine(index),
                            lambda: ArchiveGateway(index, shards=2),
                            lambda: ServeEngine(cfg, params)],
            "IndexQueryService": [lambda: IndexQueryService(index),
                                  lambda: verify_index(index),
                                  lambda: tf.params_from_jax({})],
            "digest_signature_batch": [
                lambda: digest_signature_batch([b"abcd"]),
                lambda: adler32_batch([b"abcd"]),
                lambda: verify_digests_bulk([b"a"], ["adler32:00620062"])],
            "find_pattern_mask_batch": [
                lambda: find_pattern_mask_batch([b"abcd"], b"b"),
                lambda: find_pattern_masks_multi([b"abcd"], [b"b"]),
                lambda: find_pattern_masks_multi_rowgroup(group, [3],
                                                          [b"b"]),
                lambda: flash_attention(*(cuda_default((1, 2, 4, 64)),) * 3)],
            }[entry]


@pytest.mark.parametrize("entry", ["build_index", "QueryEngine",
                                   "IndexQueryService",
                                   "digest_signature_batch",
                                   "find_pattern_mask_batch"])
def test_entry_points_default_to_the_gpu(tmp_path, entry):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from repro_torch.data.synth import CorpusSpec, write_corpus

    path = str(tmp_path / "a.warc.gz")
    write_corpus(path, CorpusSpec(n_pages=1), "gzip")
    calls = _default_device_calls(entry, path)
    before = set(threading.enumerate())
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # the gateway raised before it started a shard or supervisor thread
    assert not [t for t in set(threading.enumerate()) - before
                if t.name.startswith("gw-")]
