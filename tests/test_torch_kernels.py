"""Kernel parity: ``repro_torch`` kernel wrappers vs the JAX reference.

The same numpy-seeded inputs go through the reference wrappers (Pallas
in interpret mode, as the reference's own tests run them) and through
the port's wrappers on the CPU, where each kernel wrapper uses its plain
PyTorch version. All outputs are integers and must be bit-identical.
The CUDA kernels themselves are checked against the plain versions by
the ``cuda``-marked tests, which skip where there is no GPU and need no
JAX: on a GPU machine without the reference,
``pytest -m cuda tests/test_torch_kernels.py`` runs them alone.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.kernels.bucketing import bucket_width
from repro_torch.kernels.digest_sig import (
    digest_sig_partials_batch, digest_sig_plain, digest_signature_batch)
from repro_torch.kernels.pattern_scan import (
    count_matches, find_pattern_mask_batch, find_pattern_positions,
    pattern_scan_batch, pattern_scan_plain)
from repro_torch.kernels.pattern_scan.ref import pattern_mask_ref
from repro_torch.obs.kernels import pad_waste_report, reset_shape_cache

SCAN_BLOCK = 256  # small tiles keep the interpreted reference grid short
PATTERN = b"WARC/1.1\r\nWARC-T"  # 16 bytes


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's wrappers and oracles (imported here, not at
    module level, so the ``cuda`` tests also run where JAX is absent)."""
    import repro.obs
    from repro.kernels.digest_sig import (digest_signature_batch,
                                          digest_signature_reference)
    from repro.kernels.pattern_scan import find_pattern_mask_batch
    from repro.kernels.pattern_scan.ref import pattern_mask_ref as mask_ref
    from repro.obs.kernels import pad_waste_report, reset_shape_cache

    return SimpleNamespace(
        obs=repro.obs, digest=digest_signature_batch,
        digest_oracle=digest_signature_reference,
        find=find_pattern_mask_batch, mask_oracle=mask_ref,
        pad_report=pad_waste_report, reset_shapes=reset_shape_cache)


def _scan_batch(seed: int) -> list[bytes]:
    """Ragged payloads over >= 3 width buckets, the pattern planted across
    tile edges and at each row's end; small alphabet so short prefixes of
    the pattern also match at random."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"WARC/1.\r\n-T", np.uint8)
    bufs = []
    for size in (0, 5, 200, 255, 256, 500, 700):
        buf = bytearray(rng.choice(alphabet, size).tobytes())
        for at in (SCAN_BLOCK - 7, 2 * SCAN_BLOCK - 15, size - 16):
            if 0 <= at and at + 16 <= size:
                buf[at:at + 16] = PATTERN
        bufs.append(bytes(buf))
    return bufs


def _digest_batch(seed: int, kind: str = "both") -> list[bytes]:
    """Random payloads of sub-2048 and multi-block widths, some shorter
    than the n-gram ("random"), and all-0xFF rows that force the uint32
    hash wrap ("0xff")."""
    rng = np.random.default_rng(seed)
    rand = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (0, 3, 100, 700, 2048, 2049, 5000)]
    ff = [b"\xff" * n for n in (255, 2048, 4100)]
    return {"random": rand, "0xff": ff, "both": rand + ff}[kind]


@pytest.mark.parametrize("plen", [1, 4, 16])
def test_find_pattern_mask_batch_matches_reference(ref, plen):
    bufs = _scan_batch(plen)
    assert len({bucket_width(len(b), SCAN_BLOCK) for b in bufs}) >= 3
    got = find_pattern_mask_batch(bufs, PATTERN[:plen], block=SCAN_BLOCK,
                                  device="cpu")
    want = ref.find(bufs, PATTERN[:plen], block=SCAN_BLOCK, interpret=True)
    for g, w, buf in zip(got, want, bufs):
        assert g.dtype == np.uint8 and g.shape == (len(buf),)
        np.testing.assert_array_equal(g, w)
    if plen == 16:  # the planted matches straddle tile edges
        assert find_pattern_positions(bufs[-1], PATTERN, block=SCAN_BLOCK,
                                      device="cpu").tolist()[:2] == [
            SCAN_BLOCK - 7, 2 * SCAN_BLOCK - 15]
        assert count_matches(bufs[-1], PATTERN, block=SCAN_BLOCK,
                             device="cpu") == int(want[-1].sum())


def test_find_pattern_mask_batch_rejects_like_reference(ref):
    for bad in (b"", b"\x00\x00", b"x" * 17):
        with pytest.raises(ValueError):
            find_pattern_mask_batch([b"abc"], bad, device="cpu")
        with pytest.raises(ValueError):
            ref.find([b"abc"], bad)
    assert find_pattern_mask_batch([], b"a", device="cpu") == []


@pytest.mark.parametrize("kind", ["random", "0xff"])
def test_digest_signature_batch_matches_reference(ref, kind):
    bufs = _digest_batch(3, kind)
    d, s = digest_signature_batch(bufs, device="cpu")
    rd, rs = ref.digest(bufs, interpret=True)
    assert d.dtype == np.uint32 and s.dtype == np.uint64
    np.testing.assert_array_equal(d, rd)
    np.testing.assert_array_equal(s, rs)


def test_digest_signature_batch_empty_and_bad_geometry(ref):
    d, s = digest_signature_batch([], device="cpu")
    rd, rs = ref.digest([])
    assert (d.shape, s.shape, d.dtype, s.dtype) == (
        rd.shape, rs.shape, rd.dtype, rs.dtype)
    for kw in ({"bits": 96}, {"bits": 100}, {"n": 1}, {"n": 130}, {"k": 0}):
        with pytest.raises(ValueError):
            digest_signature_batch([b"abcd"], device="cpu", **kw)
        with pytest.raises(ValueError):
            ref.digest([b"abcd"], **kw)


def test_plain_pattern_scan_matches_reference_oracle(ref):
    # each row of the plain matrix version vs both packages' oracles
    rng = np.random.default_rng(11)
    width = 64
    m = np.zeros((5, width + 16), np.uint8)
    m[:4, :width] = rng.choice(np.frombuffer(b"ab", np.uint8), (4, width))
    m[3, :width] = 0xFF
    for pat in (b"a", b"ab", b"abab", b"\xff" * 16):
        vec = np.zeros(16, np.uint8)
        vec[:len(pat)] = np.frombuffer(pat, np.uint8)
        got = pattern_scan_plain(torch.from_numpy(m), vec, len(pat)).numpy()
        for r in range(m.shape[0]):
            p = np.frombuffer(pat, np.uint8)
            want = np.asarray(ref.mask_oracle(m[r], p))
            np.testing.assert_array_equal(pattern_mask_ref(m[r], p), want)
            # the oracle sees the row with its zero tail; windows into the
            # tail never match a pattern without zero bytes
            np.testing.assert_array_equal(got[r], want[:width])


def test_plain_digest_sig_matches_reference_oracle(ref):
    # the plain-version path vs the reference's two-pass host oracle
    bufs = _digest_batch(5)
    d, s = digest_signature_batch(bufs, device="cpu")
    rd, rs = ref.digest_oracle(bufs)
    np.testing.assert_array_equal(d, rd)
    np.testing.assert_array_equal(s, rs)


def test_dispatch_counters_equal_between_packages(ref):
    scan, dig = _scan_batch(21), _digest_batch(22)
    for reg, reset in ((obs, reset_shape_cache),
                       (ref.obs, ref.reset_shapes)):
        reg.reset()
        reset()
    find_pattern_mask_batch(scan, b"WARC", block=SCAN_BLOCK, device="cpu")
    find_pattern_mask_batch(scan, b"WARC", block=SCAN_BLOCK, device="cpu")
    digest_signature_batch(dig, device="cpu")
    ref.find(scan, b"WARC", block=SCAN_BLOCK)
    ref.find(scan, b"WARC", block=SCAN_BLOCK)
    ref.digest(dig)

    def kernel_counters(snap):
        return {k: v for k, v in snap.counters.items()
                if k.startswith("kernel.")}

    got, want = obs.snapshot(), ref.obs.snapshot()
    assert kernel_counters(got) == kernel_counters(want)
    assert got.counter("kernel.find_pattern_mask_batch.shape_reuses") > 0
    assert pad_waste_report(got) == ref.pad_report(want)


def test_kernel_wrappers_reject_bad_inputs():
    vec = np.zeros(16, np.uint8)
    vec[0] = 1
    with pytest.raises(ValueError):  # width not a multiple of 16
        pattern_scan_batch(torch.zeros((2, 16 + 10), dtype=torch.uint8),
                           vec, 1)
    with pytest.raises(ValueError):  # neither cuda nor cpu
        pattern_scan_batch(torch.zeros((2, 32), dtype=torch.uint8,
                                       device="meta"), vec, 1)
    with pytest.raises(ValueError):  # width not a multiple of block
        digest_sig_partials_batch(torch.zeros((2, 128 + 100),
                                              dtype=torch.uint8), n=4)
    with pytest.raises(ValueError):  # n-gram longer than the zero tail
        digest_sig_partials_batch(torch.zeros((2, 128 + 256),
                                              dtype=torch.uint8), n=130,
                                  block=256)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
def test_cuda_pattern_scan_matches_plain():
    _need_gpu()
    for plen in (1, 4, 16):
        _check_cuda_pattern_scan(plen)


def _check_cuda_pattern_scan(plen: int) -> None:
    from repro_torch.kernels.pattern_scan import pattern_scan as mod

    rng = np.random.default_rng(plen)
    m = np.zeros((7, 8192 + 16), np.uint8)
    m[:6, :8192] = rng.choice(np.frombuffer(PATTERN, np.uint8), (6, 8192))
    m[5, :8192] = 0xFF
    for r in range(5):  # whole, across a 16-byte chunk edge, into the tail
        for at in (0, 16 - 3, 8192 - 9):
            end = min(at + 16, 8192)
            m[r, at:end] = np.frombuffer(PATTERN, np.uint8)[:end - at]
    vec = np.frombuffer(PATTERN, np.uint8).copy()
    x = torch.from_numpy(m).cuda()
    before = mod.launches
    got = mod.pattern_scan_batch(x, vec, plen)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    assert torch.equal(got, mod.pattern_scan_plain(x, vec, plen))
    masks = find_pattern_mask_batch(_scan_batch(plen), PATTERN[:plen],
                                    block=SCAN_BLOCK, device="cuda")
    for g, w in zip(masks, find_pattern_mask_batch(
            _scan_batch(plen), PATTERN[:plen], block=SCAN_BLOCK,
            device="cpu")):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_cuda_digest_sig_matches_plain():
    _need_gpu()
    for width in (256, 1536, 6144):
        _check_cuda_digest_sig(width)


def _check_cuda_digest_sig(width: int) -> None:
    from repro_torch.kernels.digest_sig import digest_sig as mod

    rng = np.random.default_rng(width)
    m = np.zeros((6, width + 128), np.uint8)
    m[:4, :width] = rng.integers(0, 256, (4, width), dtype=np.uint8)
    m[4, :width] = 0xFF
    x = torch.from_numpy(m).cuda()
    kblock = min(2048, width)
    before = mod.launches
    got = mod.digest_sig_partials_batch(x, n=4, block=kblock)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    for g, w in zip(got, digest_sig_plain(x, n=4, block=kblock)):
        assert torch.equal(g, w)
    bufs = _digest_batch(width)
    for g, w in zip(digest_signature_batch(bufs, device="cuda"),
                    digest_signature_batch(bufs, device="cpu")):
        np.testing.assert_array_equal(g, w)
