"""Time the build phase alone on the card: ``build_index(device="cuda")``
over ``chip_smoke.py``'s corpus, in a fresh process, optionally after some
of ``chip_smoke.py``'s phase-4 checks.

The build's records/s is host-bound (parse and signature fold) and moves
by ±20 % between processes on one machine. To tell a change in the code
from that noise, run this script from two checkouts in turns (A, B, B, A)
in one call on the card and compare the stage splits it prints.

Usage::

    python3 tools/build_ab.py [--after kernel_checks,multi_checks]
                              [--reps 2] [--corpus DIR]

The corpus (4 gzip shards of 10,000 pages, as ``chip_smoke.py`` writes
them) is made in ``DIR`` when it is missing, so checkouts can share one.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--after", default="",
                    help="comma-separated chip_smoke phase-4 checks to run "
                         "first (kernel_checks, rowgroup_checks, "
                         "multi_checks, adler_checks, flash_checks)")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--corpus", type=Path, default=ROOT / "build" / "ab_corpus")
    args = ap.parse_args()

    import chip_smoke as cs
    import torch
    from repro_torch import obs
    from repro_torch.index import build_index

    if not args.corpus.exists():
        cs.make_corpus(args.corpus, 10_000)
    paths = sorted(str(p) for p in args.corpus.glob("*.warc.gz"))
    cs._build.build_all()
    torch.cuda.synchronize()
    print(cs.device_line(), flush=True)
    results: dict = {}
    t0 = time.perf_counter()
    for name in filter(None, args.after.split(",")):
        getattr(cs, name)(results)
    print(f"{ROOT.name} after [{args.after}]: checks "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for rep in range(args.reps):
        obs.reset()
        t0 = time.perf_counter()
        index = build_index(paths, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = obs.snapshot().counters
        print(f"{ROOT.name} rep {rep}: {len(index) / dt:.1f} records/s, parse "
              f"{c.get('index.stage.parse_us', 0) / 1e6:.3f} s, fold "
              f"{c.get('stage.digest_signature_batch.fold_us', 0) / 1e6:.3f}"
              f" s, pack "
              f"{c.get('stage.digest_signature_batch.pack_us', 0) / 1e6:.3f}"
              f" s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
