"""Host oracle for the pattern-scan kernel."""
from __future__ import annotations

import numpy as np


def pattern_mask_ref(buf, pattern) -> np.ndarray:
    """mask[i] = 1 iff buf[i:i+len(pattern)] == pattern (uint8 arrays)."""
    buf = np.asarray(buf, dtype=np.uint8)
    pattern = np.asarray(pattern, dtype=np.uint8)
    n, p = buf.size, pattern.size
    if n < p:
        return np.zeros((max(n, 0),), dtype=np.uint8)
    acc = np.ones((n - p + 1,), dtype=bool)
    for j in range(p):
        acc &= buf[j:n - p + 1 + j] == pattern[j]
    # positions whose window would run past the end can never match
    return np.concatenate(
        [acc, np.zeros((p - 1,), dtype=bool)]).astype(np.uint8)
