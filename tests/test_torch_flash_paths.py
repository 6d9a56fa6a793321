"""The flash-attention kernel's host-side choices, and its plain version at
every head dim the kernel takes, on the CPU.

The CUDA kernel picks its path per call (split-KV decode when
``(H // Hkv) * Sq <= 16``, on CUDA cores in f32 and tensor cores in bf16,
else bf16 prefill on tensor cores or f32 prefill on CUDA cores) and, for
decode, a split count from the shape and type alone
(``decode_splits``). The split count sizes the workspace the wrapper
allocates, so it is pinned here case by case. The plain version
(``attention_plain``, what a CPU tensor takes) is held against the
reference's ``attention_ref`` at D = 16, 32, 64 and 128 on ragged and
decode-like shapes (rtol 1e-4 / atol 1e-5, f32; rows with no key
excluded, where ``attention_ref`` gives NaN and the plain version 0).
The kernel itself is held against the plain version by the ``cuda``
tests of ``tests/test_torch_attention.py``.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import attention_plain

KERNEL = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")


@pytest.mark.parametrize("b,hkv,sk,want,want_bf16", [
    (8, 4, 1, 1, 1),        # one key
    (8, 4, 256, 1, 1),      # fastwarc_lm's profiled decode: 4 tiles, unsplit
    (8, 4, 257, 2, 1),      # a fifth tile: 2 splits in f32
    # 32 pairs over 16 tiles (fastwarc_lm at 1,000 keys, Qwen3-30B-A3B at
    # 1,024): 4 f32 splits fill 128 of 132 SMs; 32 blocks unsplit in bf16
    (8, 4, 1024, 4, 1),
    (8, 8, 2000, 2, 1),     # 64 pairs: one wave holds 2 splits
    (1, 1, 100, 1, 1),      # fewer than 4 tiles a split: unsplit
    (1, 1, 9999, 40, 40),   # 157 tiles, 4 a split: 40 blocks
    (1, 8, 5000, 16, 7),    # one wave: 132 // 8; under 64 blocks in bf16
    (300, 1, 500, 1, 1),    # more pairs than SMs
])
def test_decode_splits(b, hkv, sk, want, want_bf16):
    """At most one wave of blocks (one an SM of the H100's 132), at least
    4 of the 64-key tiles a split, at least one split; the bf16 decode
    (tensor cores) to fewer than 64 blocks."""
    for bf16, expect in ((False, want), (True, want_bf16)):
        n = KERNEL.decode_splits(b, hkv, sk, bf16=bf16)
        assert n == expect, bf16
        assert n == 1 or b * hkv * n <= 132
        assert n <= -(-sk // 64)
    assert want_bf16 <= want


@pytest.mark.parametrize("d", [16, 32, 128])
def test_plain_attention_head_dims_match_reference(d):
    """GQA prefill with ragged Sq/Sk, rows with no key (causal, Sq > Sk)
    and decode (Sq = 1) at head dim d: the plain version against the
    reference's exact attention."""
    from repro.kernels.flash_attention.ref import attention_ref

    rng = np.random.default_rng(d)
    for b, h, hkv, sq, sk in ((2, 6, 2, 37, 37), (1, 4, 2, 40, 25),
                              (3, 12, 4, 1, 130)):
        q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
        k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
        v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
        for causal in (True, False):
            got = attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=causal).numpy()
            want = np.asarray(attention_ref(q, k, v, causal=causal))
            keyed = slice(max(0, sq - sk) if causal else 0, None)
            np.testing.assert_allclose(
                got[:, :, keyed], want[:, :, keyed], rtol=1e-4, atol=1e-5,
                err_msg=f"{(b, h, hkv, sq, sk, d)} causal={causal}")
            if causal and sq > sk:
                assert not got[:, :, :sq - sk].any()


def test_plain_attention_ignores_the_fp32_matmul_mode():
    """The plain version on the CPU does not move with the process's fp32
    matrix-product mode: the failing case of a whole-suite run
    ((2, 6, 2, 37, 37), D = 16, causal) stays within 1e-6 of a float64
    numpy truth under ``set_float32_matmul_precision("medium")``, which
    routes fp32 products through a reduced-precision path on CPUs that
    have one (an AMX-BF16 Xeon, where fp32 math fails this)."""
    rng = np.random.default_rng(16)
    q = rng.standard_normal((2, 6, 37, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 37, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 37, 16)).astype(np.float32)
    k64 = np.repeat(k, 3, axis=1).astype(np.float64)
    v64 = np.repeat(v, 3, axis=1).astype(np.float64)
    s = q.astype(np.float64) @ k64.swapaxes(-1, -2) / 4.0
    s = np.where(np.tril(np.ones((37, 37), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    truth = (p / p.sum(-1, keepdims=True)) @ v64
    prev = torch.get_float32_matmul_precision()
    try:
        for mode in ("highest", "medium"):
            torch.set_float32_matmul_precision(mode)
            got = attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=True)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), truth, rtol=0, atol=1e-6,
                                       err_msg=mode)
    finally:
        torch.set_float32_matmul_precision(prev)
