"""Grouped launches: ``digest_signature_batch`` sweeps every width bucket of
a call in one launch of the fused kernel, and the row-group scans (one
pattern, and one pattern per row) run the early-exit body.

The packing and unpacking (descriptor table, offsets, per-bucket views)
run on every device; on the CPU each table entry goes through
``digest_sig_plain``, and the results are held against the JAX
reference's ``digest_signature_batch`` (Pallas in interpret mode) and
against ``zlib.adler32`` / ``signature_of``; the per-row-pattern row-group
scan's plain version against the reference's
``pattern_scan_rowgroup_multi``. The ``cuda``-marked tests
hold the CUDA kernels against their plain versions on the card, need no
JAX, and skip where there is no GPU:
``pytest -m cuda tests/test_torch_kernel_groups.py``.
"""
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.index.signature import signature_of
from repro_torch.kernels.digest_sig import digest_signature_batch
from repro_torch.kernels.digest_sig import digest_sig as ds
from repro_torch.kernels.digest_sig.ops import pack_batch
from repro_torch.obs.kernels import reset_shape_cache


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's wrapper and registry (imported here, not at
    module level, so the ``cuda`` tests also run where JAX is absent)."""
    import repro.obs
    from repro.kernels.digest_sig import digest_signature_batch as digest
    from repro.kernels.pattern_scan.pattern_scan import (
        pattern_scan_rowgroup_multi as rowgroup_multi)
    from repro.obs.kernels import reset_shape_cache as reset_shapes

    return SimpleNamespace(obs=repro.obs, digest=digest,
                           rowgroup_multi=rowgroup_multi,
                           reset_shapes=reset_shapes)


def _ragged(seed: int) -> list[bytes]:
    """Payloads over many width buckets: empty, shorter than any n-gram,
    sub-2048 widths, exact bucket edges, multi-block rows, all-0xFF rows
    (the uint32 hash wrap) and a small alphabet (repeated n-grams)."""
    rng = np.random.default_rng(seed)
    out = [b"", b"", b"ab"]
    for n in (100, 255, 256, 700, 1536, 2047, 2048, 2049, 5000, 9000):
        out.append(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    out += [b"\xff" * 300, b"\xff" * 4100,
            rng.choice(np.frombuffer(b"WARC/1.", np.uint8), 3000).tobytes()]
    return out


def _oracle(bufs, n):
    return (np.asarray([zlib.adler32(b) for b in bufs], np.uint32),
            np.stack([signature_of(b, n=n) for b in bufs]))


@pytest.mark.parametrize("n", [4, 24])  # the index's n-gram, the general path
def test_grouped_batch_matches_reference(ref, n):
    bufs = _ragged(n)
    _, table, _, members = pack_batch([np.frombuffer(b, np.uint8)
                                       for b in bufs])
    assert table.size >= 8 and sum(map(len, members)) == len(bufs)
    d, s = digest_signature_batch(bufs, n=n, device="cpu")
    rd, rs = ref.digest(bufs, n=n, interpret=True)
    np.testing.assert_array_equal(d, rd)
    np.testing.assert_array_equal(s, rs)
    od, osig = _oracle(bufs, n)
    np.testing.assert_array_equal(d, od)
    np.testing.assert_array_equal(s, osig)


def test_single_bucket_and_empty_batches():
    rng = np.random.default_rng(7)
    cases = {
        "one bucket": [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
                       for k in rng.integers(1537, 2049, 9)],
        "all empty": [b"", b"", b""],
        "one payload below 2048": [b"x" * 300],
    }
    for name, bufs in cases.items():
        _, table, _, _ = pack_batch([np.frombuffer(b, np.uint8)
                                     for b in bufs])
        assert table.size == 1, name
        d, s = digest_signature_batch(bufs, device="cpu")
        od, osig = _oracle(bufs, 4)
        np.testing.assert_array_equal(d, od, err_msg=name)
        np.testing.assert_array_equal(s, osig, err_msg=name)


def test_grouped_dispatch_counters_equal_reference(ref):
    bufs = _ragged(31)
    for reg, reset in ((obs, reset_shape_cache),
                       (ref.obs, ref.reset_shapes)):
        reg.reset()
        reset()
    for _ in range(2):
        digest_signature_batch(bufs, device="cpu")
        ref.digest(bufs)
    got, want = obs.snapshot(), ref.obs.snapshot()

    def kernel_counters(snap):
        return {k: v for k, v in snap.counters.items()
                if k.startswith("kernel.")}

    assert kernel_counters(got) == kernel_counters(want)
    buckets = len(pack_batch([np.frombuffer(b, np.uint8) for b in bufs])[1])
    assert got.counter("kernel.digest_signature_batch.dispatches") == \
        2 * buckets


def test_group_table_offsets_aligned_and_disjoint():
    rng = np.random.default_rng(3)
    shapes = [(int(rng.integers(0, 9)), int(k) * int(w), int(w))
              for k, w in zip(rng.integers(1, 5, 12),
                              rng.choice([16, 48, 256, 768, 2048, 4096],
                                         12))]
    table, in_bytes, words = ds.group_layout(shapes)
    spans_in, spans_out = [], []
    for e, (rows, width, kblock) in zip(table, shapes):
        assert (e["rows"], e["width"], e["kblock"]) == (rows, width, kblock)
        assert e["in_off"] % 16 == 0 and e["h_off"] % 4 == 0
        spans_in.append((int(e["in_off"]), rows * (width + ds.HPAD)))
        spans_out += [(int(e["s_off"]), rows * (width // kblock)),
                      (int(e["t_off"]), rows * (width // kblock)),
                      (int(e["h_off"]), rows * width)]
    for spans, limit in ((spans_in, in_bytes), (spans_out, words)):
        spans.sort()
        for (a, na), (b, _) in zip(spans, spans[1:]):
            assert a + na <= b
        assert spans[-1][0] + spans[-1][1] <= limit
    # the CPU walk of the table: each entry equals digest_sig_plain of its
    # own matrix, and the buffer's padding stays untouched
    buf = torch.from_numpy(rng.integers(0, 256, in_bytes, dtype=np.uint8))
    out = torch.full((words,), -7, dtype=torch.int32)
    ds.digest_sig_group(buf, table, out, n=5)
    written = torch.zeros(words, dtype=torch.bool)
    for e, (s, t, h) in zip(table, ds.group_views(out, table)):
        rows, width = int(e["rows"]), int(e["width"])
        off = int(e["in_off"])
        mat = buf[off:off + rows * (width + ds.HPAD)].reshape(rows, -1)
        for got, want in zip((s, t, h), ds.digest_sig_plain(
                mat, n=5, block=int(e["kblock"]))):
            assert torch.equal(got, want)
        for key, size in (("s_off", s.numel()), ("t_off", t.numel()),
                          ("h_off", h.numel())):
            written[int(e[key]):int(e[key]) + size] = True
    assert (out[~written] == -7).all()
    # a one-entry group is what digest_sig_partials_batch launches
    one = buf[:3 * (256 + ds.HPAD)].reshape(3, -1)
    for got, want in zip(ds.digest_sig_partials_batch(one, n=4, block=256),
                         ds.digest_sig_plain(one, n=4, block=256)):
        assert torch.equal(got, want)
    bad = table.copy()
    bad[1]["in_off"] += 8
    with pytest.raises(ValueError):
        ds.digest_sig_group(buf, bad, out, n=5)
    with pytest.raises(ValueError):
        ds.digest_sig_group(buf, table, out[:-1], n=5)


def _multi_rowgroup(rng, rows: int, width: int, lens) -> tuple:
    """A (rows, W + 128) row-group over a small alphabet, every payload the
    whole width, and row r's pattern of length ``lens[r]`` (0, negative or
    above 16 take 16 bytes) planted at the start, across a chunk edge and
    at the row's end; where the width allows, row 0's last bytes "ab"
    with the pattern "ab" and 14 zero bytes, a match that runs into the
    zero tail. Returns the matrix, the (rows, 16) patterns and the (rows,)
    int32 lengths as numpy arrays."""
    alphabet = np.frombuffer(b"WARC/1.\r\n-T", np.uint8)
    m = np.zeros((rows, width + 128), np.uint8)
    m[:, :width] = rng.choice(alphabet, (rows, width))
    pats = rng.choice(alphabet, (rows, 16))
    lens = np.asarray(lens, np.int32)
    for r in range(rows):
        k = int(lens[r]) if 1 <= lens[r] <= 16 else 16
        pats[r, k:] = 0
        for at in (0, 13, width - k):
            if at >= 0:
                end = min(at + k, width)
                m[r, at:end] = pats[r, :end - at]
    if width >= 16:
        m[0, width - 2:width] = pats[0, :2] = (ord("a"), ord("b"))
        pats[0, 2:] = 0
        lens[0] = 16
    return m, pats, lens


def test_rowgroup_multi_plain_matches_reference(ref):
    """The plain version (what the wrapper runs on the CPU) against the
    reference's Pallas kernel in interpret mode: lengths 1..16 across the
    rows, 0, negative and above max_len; max_len 16 and 7."""
    from repro_torch.kernels.pattern_scan import pattern_scan as ps

    rng = np.random.default_rng(11)
    lens = [*range(1, 17), 0, -3, 40, 17]
    m, pats, n = _multi_rowgroup(rng, len(lens), 48, lens)
    for max_len in (16, 7):
        got = ps.pattern_scan_rowgroup_multi(
            torch.from_numpy(m), torch.from_numpy(pats),
            torch.from_numpy(n), max_len)
        want = np.asarray(ref.rowgroup_multi(
            m, pats, n.reshape(-1, 1), max_len=max_len, interpret=True))
        np.testing.assert_array_equal(got.numpy(), want)
        assert want[0, 46] == 1 and want.sum() > len(lens)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _cuda_group(rng, shapes):
    """A device buffer holding each shape's matrix: random payload rows,
    one all-0xFF row and one empty row per matrix (rows >= 3)."""
    table, in_bytes, words = ds.group_layout(shapes)
    flat = np.zeros(in_bytes, np.uint8)
    for e in table:
        rows, width = int(e["rows"]), int(e["width"])
        off = int(e["in_off"])
        mat = flat[off:off + rows * (width + ds.HPAD)].reshape(rows, -1)
        for r in range(rows - 1):
            k = int(rng.integers(0, width + 1))
            mat[r, :k] = rng.integers(0, 256, k, dtype=np.uint8)
        mat[0, :width] = 0xFF
    return torch.from_numpy(flat).cuda(), table, words


@pytest.mark.cuda
def test_cuda_grouped_digest_sig_matches_plain():
    _need_gpu()
    rng = np.random.default_rng(0)
    fast = [(3, 16, 16), (5, 256, 256), (4, 768, 768), (6, 1536, 1536),
            (4, 2048, 2048), (3, 6144, 2048), (3, 1 << 20, 2048)]
    general = fast[:4] + [(3, 8192, 4096)]  # a block > 2048: general body
    for shapes in (fast, general):
        x, table, words = _cuda_group(rng, shapes)
        for n in (2, 4, 16, 17, 24, 129):
            out = torch.full((words,), -7, dtype=torch.int32, device="cuda")
            before = ds.launches
            ds.digest_sig_group(x, table, out, n=n)
            torch.cuda.synchronize()
            assert ds.launches == before + 1
            for e, got in zip(table, ds.group_views(out, table)):
                rows, width = int(e["rows"]), int(e["width"])
                off = int(e["in_off"])
                mat = x[off:off + rows * (width + ds.HPAD)].reshape(rows, -1)
                want = ds.digest_sig_plain(mat, n=n, block=int(e["kblock"]))
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (shapes, n, rows, width)
    bufs = _ragged(5)
    before = ds.launches
    got = digest_signature_batch(bufs, device="cuda")
    assert ds.launches == before + 1
    for g, w in zip(got, digest_signature_batch(bufs, device="cpu")):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_cuda_rowgroup_scan_matches_plain():
    _need_gpu()
    from repro_torch.kernels.pattern_scan import pattern_scan as ps

    rng = np.random.default_rng(1)
    pat = np.frombuffer(b"nginx/1.25\r\nDate", np.uint8)
    cases = []
    # (2, 65536): rows fewer than a wave, each row split over blocks
    for rows, width in ((1, 16), (1, 4096), (7, 16), (33, 12288),
                        (2, 65536)):
        text = np.zeros((rows, width + 128), np.uint8)
        text[:, :width] = rng.choice(pat, (rows, width))
        for r in range(rows):  # whole, across a chunk edge, at the row end
            for at in (0, 13, width - 16, width - 5):
                if at >= 0:
                    end = min(at + 16, width)
                    text[r, at:end] = pat[:end - at]
        same = np.zeros_like(text)
        same[:, :width] = pat[0]        # only the first byte ever matches
        cases += [(text, pat), (same, pat)]
        a = np.zeros_like(text)
        a[:, :width] = ord("a")         # every byte of the pattern matches
        cases.append((a, np.full(16, ord("a"), np.uint8)))
        tail = text.copy()              # a pattern that ends in the zero tail
        tail[:, width - 2:width] = (ord("a"), ord("b"))
        ptail = np.zeros(16, np.uint8)
        ptail[:2] = (ord("a"), ord("b"))
        cases.append((tail, ptail))
    for m, p in cases:
        x = torch.from_numpy(m).cuda()
        for plen in range(1, 17):
            before = ps.rowgroup_launches
            got = ps.pattern_scan_rowgroup(x, p, plen)
            want = ps.pattern_scan_rowgroup_plain(x, p, plen)
            torch.cuda.synchronize()
            assert ps.rowgroup_launches == before + 1
            assert torch.equal(got, want), (m.shape, bytes(p[:plen]))


@pytest.mark.cuda
def test_cuda_rowgroup_multi_scan_matches_plain():
    _need_gpu()
    from repro_torch.kernels.pattern_scan import pattern_scan as ps

    rng = np.random.default_rng(2)
    cases = []
    # 1 row split over blocks, more rows than a wave, width 16
    for rows, width in ((1, 12416), (2048, 256), (5, 16), (33, 1536)):
        lens = rng.integers(1, 17, rows)
        lens[1:4] = (0, 40, -3)[:max(0, rows - 1)]
        m, pats, n = _multi_rowgroup(rng, rows, width, lens)
        cases.append((m, pats, n))
        # the worst case: every row matches all 16 bytes everywhere
        a = np.zeros_like(m)
        a[:, :width] = ord("a")
        cases.append((a, np.full((rows, 16), ord("a"), np.uint8),
                      np.full(rows, 16, np.int32)))
    for m, pats, n in cases:
        x = torch.from_numpy(m).cuda()
        p = torch.from_numpy(pats).cuda()
        for lens in (n, np.minimum(n, 2)):
            nt = torch.from_numpy(np.ascontiguousarray(lens)).cuda()
            for max_len in (16, 5):
                before = ps.rowgroup_multi_launches
                got = ps.pattern_scan_rowgroup_multi(x, p, nt, max_len)
                want = ps.pattern_scan_rowgroup_multi_plain(x, p, nt, max_len)
                torch.cuda.synchronize()
                assert ps.rowgroup_multi_launches == before + 1
                assert torch.equal(got, want), (m.shape, max_len)
