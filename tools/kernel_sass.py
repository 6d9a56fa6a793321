"""Count the SASS instructions of CUDA kernels (on a machine with the CUDA
toolkit; no GPU needed).

Compiles each source with the port's ``nvcc`` flags (``-cubin`` in place
of ``-shared``) for ``sm_90a``, disassembles it with ``cuobjdump -sass``
and prints, per kernel: its instruction count, and each loop (the body
from a backward branch's target to the branch) with its instruction count
and its opcodes, innermost loops first. A loop's count is its static
size: the longest path through the body, early exits included.

Usage::

    python3 tools/kernel_sass.py [SOURCE.cu ...] [--json PATH]
    python3 tools/kernel_sass.py --compare BEFORE.cu AFTER.cu

With no source it reads the port's ``digest_sig.cu`` and
``pattern_scan.cu``. ``--compare`` compiles two versions of a source and
prints, per kernel, whether its SASS is identical in both (every opcode
and operand; kernels in an anonymous namespace are matched by name, the
namespace's per-file tag aside).
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

DEFAULT = [ROOT / "src/repro_torch/kernels/digest_sig/csrc/digest_sig.cu",
           ROOT / "src/repro_torch/kernels/pattern_scan/csrc/pattern_scan.cu"]
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_[0-9a-f]{8}")


def sass(src: Path, workdir: Path) -> str:
    """``cuobjdump -sass`` of ``src`` compiled with the build's flags."""
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cubin = workdir / f"{src.stem}.cubin"
    nvcc = _build._nvcc()
    subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin), str(src)],
                   check=True, capture_output=True)
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout


def kernels(text: str) -> dict[str, list[tuple[int, str, str]]]:
    """``function -> [(address, opcode, operands)]`` from cuobjdump."""
    out: dict[str, list[tuple[int, str, str]]] = {}
    cur = None
    for line in text.splitlines():
        if "Function :" in line:
            cur = out.setdefault(line.split("Function :")[1].strip(), [])
            continue
        m = _INSN.search(line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return out


def loops(insns: list[tuple[int, str, str]]) -> list[dict]:
    """Every backward branch's body, innermost (smallest) first."""
    found = []
    for addr, op, args in insns:
        t = _TARGET.search(args)
        if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
            start = int(t.group(1), 16)
            body = [o for a, o, _ in insns if start <= a <= addr]
            found.append({"start": hex(start), "end": hex(addr),
                          "instructions": len(body),
                          "opcodes": dict(Counter(
                              o.split(".")[0] for o in body).most_common())})
    return sorted(found, key=lambda lp: lp["instructions"])


def compare(before: Path, after: Path, workdir: Path) -> list[str]:
    """One line per kernel of ``before`` and ``after``: identical SASS,
    different SASS (with both instruction counts), or in one only."""
    a, b = ({_ANON.sub("_GLOBAL__N_", name): [(op, args) for _, op, args in ins]
             for name, ins in kernels(sass(src, workdir)).items()}
            for src in (before, after))
    out = []
    for name in sorted(a.keys() | b.keys()):
        if name not in b or name not in a:
            out.append(f"{name}: only in {before if name in a else after}")
        elif a[name] == b[name]:
            out.append(f"{name}: identical SASS ({len(a[name])} "
                       f"instructions)")
        else:
            out.append(f"{name}: SASS differs ({len(a[name])} -> "
                       f"{len(b[name])} instructions)")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="*", type=Path)
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--compare", nargs=2, type=Path, default=None,
                    metavar=("BEFORE", "AFTER"))
    args = ap.parse_args()
    report = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build"
                                     if (ROOT / "build").is_dir() else None
                                     ) as tmp:
        if args.compare:
            print("\n".join(compare(*args.compare, Path(tmp))))
            return 0
        for src in args.sources or DEFAULT:
            for name, insns in kernels(sass(src, Path(tmp))).items():
                report[f"{src}:{name}"] = {"instructions": len(insns),
                                           "loops": loops(insns)}
    for key, k in report.items():
        print(f"{key}: {k['instructions']} instructions")
        for lp in k["loops"]:
            ops = ", ".join(f"{o} {c}" for o, c in lp["opcodes"].items())
            print(f"  loop {lp['start']}-{lp['end']}: {lp['instructions']} "
                  f"instructions ({ops})")
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
