"""Grouped pattern scans: ``find_pattern_mask_batch`` and
``find_pattern_masks_multi`` sweep every width bucket of a call in one
launch of the batch scan kernel.

The packing and unpacking (descriptor table, offsets, staged patterns
and lengths, per-bucket views) run on every device; on the CPU each
table entry goes through the plain version, and the masks are held
against the JAX reference's wrappers (Pallas in interpret mode). The
``cuda``-marked tests hold the CUDA kernels against their plain versions
on the card, need no JAX, and skip where there is no GPU:
``pytest -m cuda tests/test_torch_scan_groups.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.kernels.pattern_scan import (find_pattern_mask_batch,
                                              find_pattern_masks_multi)
from repro_torch.kernels.pattern_scan import pattern_scan as ps
from repro_torch.kernels.pattern_scan.ops import pack_scan
from repro_torch.obs.kernels import reset_shape_cache

SCAN_BLOCK = 256  # small tiles keep the interpreted reference grid short
PATTERN = b"WARC/1.1\r\nWARC-T"  # 16 bytes
PATTERNS = [b"W", b"WA", b"ARC/", b"WARC/1.1", b"C/1.1\r\nW", PATTERN, b"T",
            b"1.1\r", b"RC/1.1\r\nWARC-"]
ALPHABET = np.frombuffer(b"WARC/1.\r\n-T", np.uint8)


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's wrappers and registry (imported here, not at
    module level, so the ``cuda`` tests also run where JAX is absent)."""
    import repro.obs
    from repro.kernels.pattern_scan import (find_pattern_mask_batch as find,
                                            find_pattern_masks_multi as multi)
    from repro.obs.kernels import reset_shape_cache as reset_shapes

    return SimpleNamespace(obs=repro.obs, find=find, multi=multi,
                           reset_shapes=reset_shapes)


def _ragged(seed: int, sizes=(0, 5, 16, 200, 255, 256, 257, 500, 700, 1200,
                              1600)) -> list[bytes]:
    """Payloads over >= 5 width buckets of SCAN_BLOCK, the 16-byte pattern
    planted across tile edges and its prefixes at each row's end; a small
    alphabet so short prefixes also match at random."""
    rng = np.random.default_rng(seed)
    out = []
    for i, size in enumerate(sizes):
        buf = bytearray(rng.choice(ALPHABET, size).tobytes())
        for at in (SCAN_BLOCK - 7, 2 * SCAN_BLOCK - 15):
            if at + 16 <= size:
                buf[at:at + 16] = PATTERN
        k = (16, 9, 4, 1)[i % 4]
        if size >= k:
            buf[size - k:] = PATTERN[:k]
        out.append(bytes(buf))
    return out


def _arrs(bufs):
    return [np.frombuffer(b, np.uint8) for b in bufs]


@pytest.mark.parametrize("plen", [1, 4, 16])
def test_grouped_batch_matches_reference(ref, plen):
    bufs = _ragged(plen)
    _, table, _, members = pack_scan(_arrs(bufs), SCAN_BLOCK)
    assert table.size >= 5 and sorted(sum(members, [])) == list(
        range(len(bufs)))
    got = find_pattern_mask_batch(bufs, PATTERN[:plen], block=SCAN_BLOCK,
                                  device="cpu")
    want = ref.find(bufs, PATTERN[:plen], block=SCAN_BLOCK, interpret=True)
    for g, w, buf in zip(got, want, bufs):
        assert g.dtype == np.uint8 and g.shape == (len(buf),)
        np.testing.assert_array_equal(g, w)
    assert sum(int(g.sum()) for g in got) > 0


def test_grouped_multi_matches_reference(ref):
    # one bucket of 7 rows (padded to 8) with 5 lengths in 1..16, one of 5
    # rows (padded to 6), and more buckets
    sizes = (200, 210, 220, 230, 240, 250, 256, 300, 350, 400, 450, 500, 700,
             1600)
    bufs = _ragged(40, sizes)
    pats = [PATTERNS[i % len(PATTERNS)] for i in range(len(bufs))]
    staging, table, _, members = pack_scan(
        _arrs(bufs), SCAN_BLOCK,
        patterns=[np.frombuffer(p.ljust(16, b"\0"), np.uint8) for p in pats],
        plens=[len(p) for p in pats])
    flat = staging.numpy()
    first = table[0]
    rows, live = int(first["rows"]), len(members[0])
    assert (rows, live) == (8, 7) and len({len(pats[i]) for i in members[0]}) \
        >= 5
    # inert pad rows of the other buckets: all zero, pattern [1, 0, ...] of 1
    for e, idxs in zip(table, members):
        rows, width = int(e["rows"]), int(e["width"])
        mat = flat[int(e["in_off"]):][:rows * (width + 16)].reshape(
            rows, width + 16)
        p = flat[int(e["pat_off"]):][:16 * rows].reshape(rows, 16)
        n = flat[int(e["len_off"]):][:4 * rows].view(np.int32)
        assert int(e["max_len"]) == max(len(pats[i]) for i in idxs)
        assert not mat[len(idxs):].any() and (n[len(idxs):] == 1).all()
        assert (p[len(idxs):, 0] == 1).all() and not p[len(idxs):, 1:].any()
    got = find_pattern_masks_multi(bufs, pats, block=SCAN_BLOCK, device="cpu")
    want = ref.multi(bufs, pats, block=SCAN_BLOCK, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # equal patterns: the multi form equals the single form
    same = find_pattern_masks_multi(bufs, [b"WARC"] * len(bufs),
                                    block=SCAN_BLOCK, device="cpu")
    for g, w in zip(same, find_pattern_mask_batch(bufs, b"WARC",
                                                  block=SCAN_BLOCK,
                                                  device="cpu")):
        np.testing.assert_array_equal(g, w)


def _spans_disjoint(spans, limit):
    spans = sorted(spans)
    for (a, na), (b, _) in zip(spans, spans[1:]):
        assert a + na <= b
    assert spans[-1][0] + spans[-1][1] <= limit


def test_group_table_aligned_disjoint_and_split():
    rng = np.random.default_rng(3)
    # 70 entries: more than one launch's 64, zero-row entries among them
    shapes = [(int(r), 16 * int(k), int(m)) for r, k, m in zip(
        rng.integers(0, 5, 70), rng.integers(1, 40, 70),
        rng.integers(1, 17, 70))]
    for multi in (False, True):
        table, in_bytes, mask_bytes = ps.group_layout(shapes, multi=multi)
        spans_in, spans_mask = [], []
        for e, (rows, width, max_len) in zip(table, shapes):
            assert (e["rows"], e["width"], e["max_len"]) == (rows, width,
                                                           max_len)
            assert e["in_off"] % 16 == 0 and e["mask_off"] % 16 == 0
            spans_in.append((int(e["in_off"]), rows * (width + 16)))
            spans_mask.append((int(e["mask_off"]), rows * width))
            if multi:
                assert e["pat_off"] % 16 == 0 and e["len_off"] % 16 == 0
                spans_in += [(int(e["pat_off"]), 16 * rows),
                             (int(e["len_off"]), 4 * rows)]
        _spans_disjoint(spans_in, in_bytes)
        _spans_disjoint(spans_mask, mask_bytes)
        parts = list(ps._slices(table))
        assert [p.size for p in parts] == [64, 6]
        assert np.array_equal(np.concatenate(parts), table)
        # the CPU walk of the table: each entry equals the plain version
        # of its own matrix
        buf = torch.from_numpy(rng.choice(ALPHABET, in_bytes))
        if multi:
            for e in table:
                rows = int(e["rows"])
                lens = rng.integers(-2, 20, rows).astype(np.int32)
                buf[int(e["len_off"]):][:4 * rows] = torch.from_numpy(
                    lens.view(np.uint8))
        mask = torch.full((mask_bytes,), 7, dtype=torch.uint8)
        vec = np.frombuffer(b"WARC/1.\r\n".ljust(16, b"\0"), np.uint8)
        if multi:
            ps.pattern_scan_multi_group(buf, table, mask)
        else:
            ps.pattern_scan_group(buf, table, mask, vec, 3)
        for e, got in zip(table, ps.group_views(mask, table)):
            rows, width = int(e["rows"]), int(e["width"])
            mat = buf[int(e["in_off"]):][:rows * (width + 16)].reshape(
                rows, width + 16)
            if multi:
                p = buf[int(e["pat_off"]):][:16 * rows].reshape(rows, 16)
                n = buf[int(e["len_off"]):][:4 * rows].view(torch.int32)
                want = ps.pattern_scan_multi_plain(mat, p, n,
                                                   int(e["max_len"]))
            else:
                want = ps.pattern_scan_plain(mat, vec, 3)
            assert torch.equal(got, want)
        bad = table.copy()
        bad[1]["in_off"] += 8
        with pytest.raises(ValueError):
            if multi:
                ps.pattern_scan_multi_group(buf, bad, mask)
            else:
                ps.pattern_scan_group(buf, bad, mask, vec, 3)


def test_empty_batch_and_single_bucket(ref):
    obs.reset()
    assert find_pattern_mask_batch([], b"WARC", device="cpu") == []
    assert find_pattern_masks_multi([], [], device="cpu") == []
    assert not [k for k in obs.snapshot().counters if k.startswith(
        ("kernel.", "stage.find_pattern"))]
    bufs = _ragged(9, (257, 300, 400, 511, 512))  # one bucket of width 512
    _, table, _, _ = pack_scan(_arrs(bufs), SCAN_BLOCK)
    assert table.size == 1 and int(table[0]["width"]) == 512
    for got, want in (
            (find_pattern_mask_batch(bufs, PATTERN, block=SCAN_BLOCK,
                                     device="cpu"),
             ref.find(bufs, PATTERN, block=SCAN_BLOCK, interpret=True)),
            (find_pattern_masks_multi(bufs, PATTERNS[:5], block=SCAN_BLOCK,
                                      device="cpu"),
             ref.multi(bufs, PATTERNS[:5], block=SCAN_BLOCK,
                       interpret=True))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_grouped_dispatch_counters_equal_reference(ref):
    bufs = _ragged(31)
    pats = [PATTERNS[i % len(PATTERNS)] for i in range(len(bufs))]
    for reg, reset in ((obs, reset_shape_cache),
                       (ref.obs, ref.reset_shapes)):
        reg.reset()
        reset()
    for _ in range(2):
        find_pattern_mask_batch(bufs, b"WARC", block=SCAN_BLOCK, device="cpu")
        find_pattern_masks_multi(bufs, pats, block=SCAN_BLOCK, device="cpu")
        ref.find(bufs, b"WARC", block=SCAN_BLOCK)
        ref.multi(bufs, pats, block=SCAN_BLOCK)
    got, want = obs.snapshot(), ref.obs.snapshot()

    def kernel_counters(snap):
        return {k: v for k, v in snap.counters.items()
                if k.startswith("kernel.")}

    assert kernel_counters(got) == kernel_counters(want)
    buckets = len(pack_scan(_arrs(bufs), SCAN_BLOCK)[1])
    for name in ("find_pattern_mask_batch", "find_pattern_masks_multi"):
        assert got.counter(f"kernel.{name}.dispatches") == 2 * buckets
        for stage in ("pack", "h2d", "kernel", "d2h"):
            assert f"stage.{name}.{stage}_us" in got.counters


def test_multi_loop_bound_takes_any_length():
    """Positions at or past a row's own length match; position 0 is always
    compared; lengths past max_len are cut to it."""
    rng = np.random.default_rng(5)
    rows, width = 9, 64
    m = np.zeros((rows, width + 16), np.uint8)
    m[:, :width] = rng.choice(ALPHABET, (rows, width))
    pats = np.zeros((rows, 16), np.uint8)
    for r in range(rows):
        p = np.frombuffer(PATTERNS[r], np.uint8)
        pats[r, :p.size] = p
    lens = np.array([1, 2, 0, -3, 40, 3, 16, 5, 2], np.int32)
    for max_len in (1, 4, 16):
        got = ps.pattern_scan_batch_multi(
            torch.from_numpy(m), torch.from_numpy(pats),
            torch.from_numpy(lens), max_len)
        want = np.ones((rows, width), bool)
        for r in range(rows):
            for j in range(max_len):
                if j == 0 or j < lens[r]:
                    want[r] &= m[r, j:j + width] == pats[r, j]
        np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _cuda_group(shapes, fill, multi):
    """A device group of ``shapes`` (rows, width, max_len), each matrix
    filled by ``fill(rows, width)``; the multi form's patterns are
    PATTERNS in turn, cut to max_len."""
    table, in_bytes, mask_bytes = ps.group_layout(shapes, multi=multi)
    flat = np.zeros(in_bytes, np.uint8)
    for e in table:
        rows, width = int(e["rows"]), int(e["width"])
        mat = flat[int(e["in_off"]):][:rows * (width + 16)].reshape(
            rows, width + 16)
        mat[:, :width] = fill(rows, width)
        if multi:
            p = flat[int(e["pat_off"]):][:16 * rows].reshape(rows, 16)
            n = flat[int(e["len_off"]):][:4 * rows].view(np.int32)
            for r in range(rows):
                pat = PATTERNS[r % len(PATTERNS)][:int(e["max_len"])]
                p[r, :len(pat)] = np.frombuffer(pat, np.uint8)
                n[r] = len(pat)
    return (torch.from_numpy(flat).cuda(), table,
            torch.full((mask_bytes,), 7, dtype=torch.uint8, device="cuda"))


def _check_cuda_group(x, table, mask, multi, vec=None, plen=16):
    before = ps.multi_launches if multi else ps.launches
    if multi:
        ps.pattern_scan_multi_group(x, table, mask)
    else:
        ps.pattern_scan_group(x, table, mask, vec, plen)
    torch.cuda.synchronize()
    assert (ps.multi_launches if multi else ps.launches) == before + 1
    for e, got in zip(table, ps.group_views(mask, table)):
        rows, width = int(e["rows"]), int(e["width"])
        mat = x[int(e["in_off"]):][:rows * (width + 16)].reshape(
            rows, width + 16)
        if multi:
            p = x[int(e["pat_off"]):][:16 * rows].reshape(rows, 16)
            n = x[int(e["len_off"]):][:4 * rows].view(torch.int32)
            want = ps.pattern_scan_multi_plain(mat, p, n, int(e["max_len"]))
        else:
            want = ps.pattern_scan_plain(mat, vec, plen)
        assert torch.equal(got, want), (rows, width)


# narrow rows (several a block), a row split over blocks, many rows
SHAPES = [(3, 16, 16), (5, 256, 16), (2, 4096, 16), (48, 16384, 16),
          (600, 8192, 16)]


@pytest.mark.cuda
def test_cuda_grouped_scans_worst_case_match_plain():
    _need_gpu()
    pat = np.frombuffer(b"nginx/1.25\r\nDate", np.uint8)
    for fill, vec in ((lambda r, w: ord("a"), np.full(16, ord("a"), np.uint8)),
                      (lambda r, w: np.resize(pat, w), pat.copy())):
        for multi in (False, True):
            x, table, mask = _cuda_group(SHAPES, fill, multi)
            if multi:  # every row's pattern the one whose exit never fires
                for e in table:
                    rows = int(e["rows"])
                    x[int(e["pat_off"]):][:16 * rows] = torch.from_numpy(
                        np.tile(vec, rows)).cuda()
                    x[int(e["len_off"]):][:4 * rows].view(torch.int32)[:] = 16
            for plen in (1, 7, 16):
                _check_cuda_group(x, table, mask, multi, vec, plen)


@pytest.mark.cuda
def test_cuda_multi_group_lens_below_max_len_match_plain():
    _need_gpu()
    rng = np.random.default_rng(2)
    x, table, mask = _cuda_group(
        SHAPES, lambda r, w: rng.choice(ALPHABET, (r, w)), True)
    for e in table:  # most rows far below max_len, some outside [1, 16]
        rows = int(e["rows"])
        lens = rng.choice([1, 2, 2, 3, 0, -3, 40], rows).astype(np.int32)
        x[int(e["len_off"]):][:4 * rows] = torch.from_numpy(
            lens.view(np.uint8)).cuda()
    _check_cuda_group(x, table, mask, True)
    # the one-entry form, its patterns and lengths tensors of their own
    xm = torch.zeros((48, 16384 + 16), dtype=torch.uint8, device="cuda")
    xm[:, :16384] = torch.from_numpy(rng.choice(ALPHABET, (48, 16384))).cuda()
    p = np.zeros((48, 16), np.uint8)
    for r in range(48):
        pat = PATTERNS[r % len(PATTERNS)]
        p[r, :len(pat)] = np.frombuffer(pat, np.uint8)
    p = torch.from_numpy(p).cuda()
    n = torch.from_numpy(rng.choice([1, 2, 16, 0], 48).astype(np.int32)).cuda()
    assert torch.equal(ps.pattern_scan_batch_multi(xm, p, n, 16),
                       ps.pattern_scan_multi_plain(xm, p, n, 16))


@pytest.mark.cuda
def test_cuda_one_launch_per_wrapper_call():
    _need_gpu()
    bufs = _ragged(11, (0, 5, 16, 200, 300, 700, 1600, 5000, 40000))
    pats = [PATTERNS[i % len(PATTERNS)] for i in range(len(bufs))]
    assert len(pack_scan(_arrs(bufs), SCAN_BLOCK)[1]) >= 6
    for plen in (1, 16):
        before = ps.launches
        got = find_pattern_mask_batch(bufs, PATTERN[:plen], block=SCAN_BLOCK,
                                      device="cuda")
        assert ps.launches == before + 1
        for g, w in zip(got, find_pattern_mask_batch(
                bufs, PATTERN[:plen], block=SCAN_BLOCK, device="cpu")):
            np.testing.assert_array_equal(g, w)
    before = ps.multi_launches
    got = find_pattern_masks_multi(bufs, pats, block=SCAN_BLOCK,
                                   device="cuda")
    assert ps.multi_launches == before + 1
    for g, w in zip(got, find_pattern_masks_multi(bufs, pats,
                                                  block=SCAN_BLOCK,
                                                  device="cpu")):
        np.testing.assert_array_equal(g, w)
    # a table of 70 entries: two launches
    x, table, mask = _cuda_group([(1, 16 * (i + 1), 16) for i in range(70)],
                                 lambda r, w: ord("W"), False)
    before = ps.launches
    ps.pattern_scan_group(x, table, mask, np.frombuffer(
        PATTERN, np.uint8).copy(), 1)
    torch.cuda.synchronize()
    assert ps.launches == before + 2
    assert all(bool(v.all()) for v in ps.group_views(mask, table))
