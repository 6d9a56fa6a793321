"""Host oracles for the Adler-32 kernel: zlib's C implementation and a
blocked modular version in numpy."""
from __future__ import annotations

import zlib

import numpy as np

MOD = 65521
_BLOCK = 2048  # T_j = Σ t·b_t ≤ 2048·2047/2·255 ≈ 5.3e8 < 2³¹


def adler32_zlib(data: bytes) -> int:
    return zlib.adler32(data) & 0xFFFFFFFF


def adler32_blocked(buf) -> int:
    """Blocked modular Adler-32 in uint64 arithmetic: per-block S and T
    reduced mod 65521, then combined with each block's offset."""
    b = np.asarray(buf, dtype=np.uint8).astype(np.uint64)
    n = b.size
    if n == 0:
        return 1
    b = np.pad(b, (0, (-n) % _BLOCK))  # zeros add nothing to either sum
    rows = b.reshape(-1, _BLOCK)
    iota = np.arange(_BLOCK, dtype=np.uint64)
    s = rows.sum(axis=1) % MOD                          # S_j mod M
    t = (rows * iota).sum(axis=1) % MOD                 # T_j mod M
    offsets = np.arange(rows.shape[0], dtype=np.uint64) * _BLOCK
    w = (np.uint64(n) - offsets) % MOD                  # (n - o_j) mod M
    per_block = (w * s % MOD + (MOD - t)) % MOD         # (n-o_j)·S_j − T_j
    a = (1 + int(s.sum()) % MOD) % MOD
    bsum = (n % MOD + int(per_block.sum()) % MOD) % MOD
    return (bsum << 16) | a
