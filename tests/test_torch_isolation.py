"""``repro_torch`` and ``chip_smoke.py`` run without JAX and without the
reference package (index build, CDX search, columnar derive and search,
index verification, the sharded gateway, LM forward and serving), and the
port's entry points default to the GPU."""
import ast
import os
import subprocess
import sys
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
# restore and the serving CLI read data from disk
ALSO_SCANNED = {"index": ["serve"], "kernels": ["models", "configs"],
                "data": ["train", "launch"]}

_BLOCKED_RUN = r"""
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
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")
       and sys.modules[m] is not None]
assert not bad, bad
print("ISOLATED-OK", len(index))
"""


def test_port_runs_with_jax_and_reference_blocked():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, str(ROOT)],
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
        return [lambda: build_index([path]),
                lambda: tf.init_params(cfg, generator=gen),
                lambda: tf.init_cache(cfg, 1, 8)]
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
