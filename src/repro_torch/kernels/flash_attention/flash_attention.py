"""Flash-attention kernel: CUDA launch and launch counts.

``csrc/flash_attention.cu`` is blocked GQA attention with an online
softmax, the counterpart of the reference's Pallas
``flash_attention_bhsd``: fp32 softmax and accumulation over f32 or bf16
inputs, the causal diagonal aligned bottom-right (offset ``Sk - Sq``),
rows with no key left written as 0. It takes any ``Sq`` and ``Sk`` (masks
inside the kernel, no padding), ``D`` of 16, 32, 64 or 128, and strided
batch, head and sequence axes (the KV cache's ``[..., :length, :]`` views
need no copy); the last axis is contiguous. One launch a call, on one of
the paths in :data:`PATHS`, which the C entry point picks from shape and
type:

* ``decode`` / ``decode_tc`` (``(H // Hkv) * Sq <= 16``; f32 on CUDA
  cores, bf16 on tensor cores fed by TMA): the keys are split
  :func:`decode_splits` ways across blocks; the wrapper allocates the
  partials' workspace, and keeps one zeroed int32 counter a (batch, KV
  head) per device and stream, which each launch leaves zeroed (so
  launches that share it are stream-ordered);
* ``prefill_tc`` (bf16): ``wgmma`` tensor cores fed by TMA, one
  warpgroup a block;
* ``prefill_cc`` (f32): CUDA cores. Training calls take it through
  :func:`flash_attention_fwd_lse` on any f32 shape: the same entry
  point, given an ``lse`` buffer, also writes each row's log-sum-exp
  for the backward (:mod:`repro_torch.kernels.flash_attention.backward`).

Every path reads rows in 16-byte chunks, so the tensors must start on a
16-byte boundary with strides of whole chunks (4 f32 or 8 bf16 values).

:func:`flash_attention_bhsd` launches it for CUDA tensors and raises for
anything it does not take; the plain version for CPU tensors is
:func:`repro_torch.kernels.flash_attention.ref.attention_plain`, chosen by
:func:`repro_torch.kernels.flash_attention.flash_attention`. ``launches``
counts CUDA launches of the kernel, by either wrapper, and
``path_launches`` the same launches by the path they took.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["HEAD_DIMS", "PATHS", "check_shapes", "decode_splits",
           "flash_attention_bhsd", "flash_attention_fwd_lse", "launches",
           "path_launches"]

HEAD_DIMS = (16, 32, 64, 128)  # the kernel's template instances
DECODE_ROWS = 16  # (H // Hkv) * Sq up to this takes the split-KV decode path
KV_TILE = 64      # keys per tile, every path
SMS = 132         # streaming multiprocessors of an H100
SPLIT_TILES = 4   # fewest tiles a split is worth its share of the merge
TC_DECODE_BLOCKS = 64  # the bf16 decode splits to fewer blocks than this
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the C entry point's paths, by number
PATHS = ("decode", "decode_tc", "prefill_tc", "prefill_cc")

launches = 0  # CUDA launches of the kernel in this process
path_launches = dict.fromkeys(PATHS, 0)  # the same, by path
_fn = None  # the C entry point, argument types set
# decode's split counters, by (device index, stream)
_counters: dict[tuple[int, int], torch.Tensor] = {}


def _entry():
    global _fn
    if _fn is None:
        from repro_torch.kernels._build import library

        fn = library("flash_attention").flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 6
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _split_counters(device: torch.device, stream: int,
                    n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters for launches on ``stream``."""
    key = (device.index, stream)
    c = _counters.get(key)
    if c is None or c.numel() < n:
        c = _counters[key] = torch.zeros(max(n, 256), dtype=torch.int32,
                                         device=device)
    return c


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` unless q [B,H,Sq,D], k/v [B,Hkv,Sk,D] agree."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D [batch, heads, seq, dim]")
    B, H, Sq, D = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    Hkv, Sk = k.shape[1], k.shape[2]
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"q heads {H} must be a multiple of kv heads {Hkv}")
    if B < 1 or Sq < 1 or Sk < 1:
        raise ValueError("batch, Sq and Sk must be positive")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")


def decode_splits(batch: int, kv_heads: int, sk: int, *,
                  bf16: bool = False) -> int:
    """Chunks of whole 64-key tiles the decode path cuts ``[0, Sk)`` into
    (the kernel deals the tiles out as evenly as they go).

    f32 (CUDA cores): enough to give each of the H100's 132 SMs a block
    where the pairs are few, but no more than one wave of ``batch *
    kv_heads * splits`` blocks (one resident an SM: the kernel holds ~150
    registers a thread), and at least 4 tiles a chunk, below which a
    split's share of the merge costs more than its keys.

    bf16 (tensor cores, TMA): the same, but to fewer than 64 blocks. Past
    32 to 64 blocks the card reads no faster and each split adds its
    merge: on the H100, Qwen3-30B-A3B's decode (32 pairs over 1,024
    keys) takes 0.0191 / 0.0195 / 0.0199 ms at 1 / 2 / 4 splits, 64
    pairs over 2,000 keys 0.0385 / 0.0397 at 1 / 2, 8 pairs over 4,096
    keys 0.0220 / 0.0216 / 0.0207 / 0.0234 at 4 / 7 / 8 / 16, and 4
    pairs over 32,768 keys 0.0508 / 0.0456 / 0.0448 / 0.0484 at 8 / 15 /
    16 / 32.
    ``tools/flash_decode_splits.py`` times the alternatives."""
    tiles = -(-sk // KV_TILE)
    pairs = batch * kv_heads
    n = min(-(-tiles // SPLIT_TILES), SMS // pairs)
    if bf16:
        n = min(n, (TC_DECODE_BLOCKS - 1) // pairs)
    return max(1, n)


def _launch_strides(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> list[int]:
    """Check what every launch needs; returns the 9 element strides
    (batch, head, sequence of q, k, v)."""
    check_shapes(q, k, v)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    B, D, Hkv = q.shape[0], q.shape[3], k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported (one of {HEAD_DIMS})")
    if B * Hkv > 65535:
        raise ValueError(f"batch x kv heads = {B * Hkv} exceeds 65535")
    # every path reads rows in 16-byte chunks (the bf16 paths' K and V by
    # TMA): 16-byte aligned tensors with strides of whole chunks
    mult = 16 // q.element_size()
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
        st = t.stride()[:3]
        if any(s % mult for s in st) or t.data_ptr() % 16:
            raise ValueError(
                f"{name} needs a 16-byte aligned start and strides that are "
                f"multiples of {mult} elements (16 bytes; the bf16 paths "
                f"load K and V by TMA)")
        strides += st
    return strides


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, lse: torch.Tensor | None) -> torch.Tensor:
    """One launch of the C entry point; ``lse`` (f32 only) routes it to
    the f32 prefill path and is filled there."""
    strides = _launch_strides(q, k, v)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    decode = lse is None and (H // Hkv) * Sq <= DECODE_ROWS
    fn = _entry()
    out = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    n_splits = (decode_splits(B, Hkv, Sk, bf16=q.dtype == torch.bfloat16)
                if decode else 1)
    st_arr = (ctypes.c_int64 * 9)(*strides)
    taken = ctypes.c_int()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws = counters = None
        if n_splits > 1:
            ws = torch.empty(B * Hkv * n_splits * DECODE_ROWS * (D + 2),
                             dtype=torch.float32, device=q.device)
            counters = _split_counters(q.device, stream, B * Hkv)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 B, H, Hkv, Sq, Sk, D, _DTYPES[q.dtype], int(bool(causal)),
                 ctypes.cast(st_arr, ctypes.c_void_p), n_splits,
                 None if ws is None else ws.data_ptr(),
                 None if counters is None else counters.data_ptr(),
                 ctypes.byref(taken), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    path_launches[PATHS[taken.value]] += 1
    return out


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel on q [B,H,Sq,D], k/v [B,Hkv,Sk,D] (all on one
    CUDA device); returns a new contiguous [B,H,Sq,D] in q's dtype. Does
    not synchronise."""
    return _launch(q, k, v, causal, None)


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 prefill path on any f32 shape (decode-sized ones too),
    also returning each row's log-sum-exp of its scaled scores: ``(out
    [B,H,Sq,D], lse [B,H,Sq] float32)``, ``lse`` 1e30 on a row with no
    key. What a training forward saves for the backward. Does not
    synchronise."""
    if q.dtype != torch.float32:
        raise ValueError(f"the lse path takes float32, not {q.dtype}")
    B, H, Sq = q.shape[:3]
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    return _launch(q, k, v, causal, lse), lse
