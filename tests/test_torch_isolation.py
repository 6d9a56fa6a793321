"""``repro_torch`` and ``chip_smoke.py`` run without JAX and without the
reference package, and the port's entry points default to the GPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# the port's code in scan units: each subpackage, and the package's
# top-level modules together with chip_smoke.py
SUBPACKAGES = ["columnar", "core", "data", "index", "kernels", "obs"]

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
    return sorted((PORT / unit).rglob("*.py"))


@pytest.mark.parametrize("unit", SUBPACKAGES + ["top-level"])
def test_no_jax_or_reference_imports(unit):
    files = _unit_files(unit)
    if unit == "top-level":  # every subpackage is one of the scan units
        assert sorted(p.name for p in PORT.iterdir() if p.is_dir()
                      and p.name != "__pycache__") == SUBPACKAGES
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


def _default_device_call(entry: str, path: str):
    from repro_torch.index import IndexQueryService, QueryEngine, build_index
    from repro_torch.kernels.digest_sig import digest_signature_batch
    from repro_torch.kernels.pattern_scan import find_pattern_mask_batch

    if entry == "build_index":
        return lambda: build_index([path])
    index = build_index([path], device="cpu")
    return {"QueryEngine": lambda: QueryEngine(index),
            "IndexQueryService": lambda: IndexQueryService(index),
            "digest_signature_batch":
                lambda: digest_signature_batch([b"abcd"]),
            "find_pattern_mask_batch":
                lambda: find_pattern_mask_batch([b"abcd"], b"b")}[entry]


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
    call = _default_device_call(entry, path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
