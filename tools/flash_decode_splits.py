"""Time the flash-attention decode kernel at each split count (one NVIDIA GPU).

``repro_torch``'s split-KV decode cuts a (batch, KV head) pair's cached
keys into chunks of whole 64-key tiles, one block each, and merges the
blocks' partials in the last block to finish
(``kernels/flash_attention/csrc/flash_attention.cu``, path B1). The
wrapper picks the chunk count with ``decode_splits``; this script times
the kernel with that choice replaced by each count in turn, at the decode
shapes ``chip_smoke.py`` checks, so the rule can be held against the
alternatives:

    python3 tools/flash_decode_splits.py

Each time is the median of 25 launches between CUDA events, the 50 MB L2
flushed before each launch (as ``chip_smoke.py`` times kernels). Prints
one line a shape, the card's name and power limit, and exits non-zero
without a GPU.
"""
from __future__ import annotations

import importlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

fa = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")

# B, H, Hkv, Sk, D, dtype: q [B, H, 1, D] over the first Sk keys of a
# [B, Hkv, S, D] cache, S the larger of 2,048 and Sk (fastwarc_lm,
# InternLM2-1.8B's shape, and Qwen3-30B-A3B's at GQA group 8: at batch 8
# over 1,024 keys, and at batch 2 and 1 over long caches, 8 and 4 pairs;
# bf16 takes the tensor-core decode)
SHAPES = ((8, 12, 4, 256, 64, torch.float32),
          (8, 12, 4, 1000, 64, torch.float32),
          (8, 16, 8, 2000, 128, torch.bfloat16),
          (8, 32, 4, 1024, 128, torch.bfloat16),
          (2, 32, 4, 4096, 128, torch.bfloat16),
          (1, 32, 4, 8192, 128, torch.bfloat16),
          (1, 32, 4, 32768, 128, torch.bfloat16))
SPLITS = (1, 2, 4, 7, 8, 9, 15, 16, 24, 32, 33)


def time_ms(fn, flush: torch.Tensor, reps: int = 25) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(4_000_000)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_decode_splits: CUDA is not available", file=sys.stderr)
        return 2
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rule = fa.decode_splits
    try:
        for b, h, hkv, sk, d, dt in SHAPES:
            q = torch.randn((b, h, 1, d), generator=gen, device="cuda").to(dt)
            cache = torch.randn((2, b, hkv, max(2048, sk), d), generator=gen,
                                device="cuda").to(dt)
            k, v = cache[0, :, :, :sk], cache[1, :, :, :sk]
            tiles = -(-sk // fa.KV_TILE)
            cells = []
            for n in (s for s in SPLITS if s <= tiles):
                fa.decode_splits = lambda *_, n=n, **__: n
                cells.append(f"{n}: {time_ms(lambda: fa.flash_attention_bhsd(q, k, v), flush):.4f}")
            fa.decode_splits = rule
            print(f"q [{b}, {h}, 1, {d}] over {sk} keys, {str(dt)[6:]} "
                  f"(rule: {rule(b, hkv, sk, bf16=dt == torch.bfloat16)} "
                  f"splits); ms by split count: "
                  + ", ".join(cells), flush=True)
    finally:
        fa.decode_splits = rule
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
