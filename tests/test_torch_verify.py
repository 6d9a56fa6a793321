"""Verify slice parity: Adler-32 kernel, bulk digest checks, ``verify_index``.

The port (``repro_torch``, on the CPU, where each kernel wrapper runs its
plain PyTorch version) and the JAX reference (``repro``, Pallas in
interpret mode) get the same seeded inputs: Adler-32 digests, the
``kernel.adler32_batch.*`` counters, ``verify_digests_bulk`` results,
``verify_index`` results and the digest flags set on read must be
identical. Cases are loops inside few tests (the file keeps a small item
count). The reference is imported by the ``ref`` fixture, not at module
level, so the ``cuda`` test also runs where JAX is absent:
``pytest -m cuda tests/test_torch_verify.py``.
"""
import importlib
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch.index as P
from repro_torch import obs
from repro_torch.core.warc import FastWARCIterator, read_record_at
from repro_torch.core.warc.checksum import (adler32_reference, block_digest,
                                            verify_digest,
                                            verify_digests_bulk)
from repro_torch.data.synth import CorpusSpec, generate_warc, write_corpus
from repro_torch.kernels.adler32 import (adler32, adler32_batch,
                                         adler32_blocked)
from repro_torch.obs.kernels import reset_shape_cache


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's Adler-32 wrapper, checksum module, index
    package and parser."""
    import repro.core.warc.checksum as checksum
    import repro.index
    import repro.obs
    from repro.core.warc import fastwarc
    from repro.kernels.adler32 import adler32_batch as ref_adler32_batch
    from repro.obs.kernels import reset_shape_cache as ref_reset_shapes

    return SimpleNamespace(adler32_batch=ref_adler32_batch,
                           checksum=checksum, index=repro.index,
                           obs=repro.obs, fastwarc=fastwarc,
                           reset_shapes=ref_reset_shapes)


def _payloads(seed: int) -> list[bytes]:
    """Empty, 1-byte, exactly one block, all-0xFF rows (the largest T of
    a block) and multi-block payloads across several width buckets."""
    rng = np.random.default_rng(seed)
    rand = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (1, 2047, 2048, 2049, 6000, 9000, 70_000)]
    ff = [b"\xff" * n for n in (1, 2048, 4096, 5000, 16_384)]
    return [b""] + rand + ff + [b"", b"x"]


def test_adler32_batch_matches_reference_and_zlib(ref):
    bufs = _payloads(0)
    got = adler32_batch(bufs, device="cpu")
    want = ref.adler32_batch(bufs, interpret=True)
    zl = np.asarray([zlib.adler32(b) for b in bufs], np.uint32)
    assert got.dtype == np.uint32 and got.shape == (len(bufs),)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, zl)
    for b in bufs:
        assert adler32(b, device="cpu") == zlib.adler32(b)
        assert adler32_blocked(np.frombuffer(b, np.uint8)) == zlib.adler32(b)
    for b in bufs[:4]:  # the pure-Python oracle is slow: short ones
        assert adler32_reference(b) == zlib.adler32(b)
    assert adler32_batch([], device="cpu").shape == (0,)


def test_adler32_counters_equal_to_reference(ref):
    bufs = _payloads(1)
    obs.reset()
    reset_shape_cache()
    ref.obs.reset()
    ref.reset_shapes()
    adler32_batch(bufs, device="cpu")
    ref.adler32_batch(bufs, interpret=True)

    def mine(counters):
        return {k: v for k, v in counters.items()
                if k.startswith("kernel.adler32_batch.")}

    got = mine(obs.snapshot().counters)
    assert got and got == mine(ref.obs.snapshot().counters)
    assert got["kernel.adler32_batch.dispatches"] >= 4  # several buckets
    stages = obs.snapshot().counters
    assert any(k.startswith("stage.adler32_batch.") for k in stages)


def _headers_and_datas() -> tuple[list[bytes], list[str]]:
    rng = np.random.default_rng(2)
    datas, headers = [], []
    for n in (0, 1, 100, 2048, 5000):
        d = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        datas += [d] * 10
        sha = block_digest(d, "sha1")
        headers += [
            sha,                                             # base32
            "sha1:" + zlib.crc32(b"x").to_bytes(4, "big").hex(),  # wrong
            block_digest(d, "md5").upper(),                  # ALGO case
            block_digest(d, "crc32"),
            block_digest(d, "adler32"),
            f"adler32:{(zlib.adler32(d) ^ 1):08x}",          # flipped bit
            " ADLER32 : " + f"{zlib.adler32(d):x}",          # spaces, case
            "adler32:zz",                                    # malformed
            "crc32:",                                        # malformed
            "whirlpool:abc" if n % 2 else "no-colon",        # unknown
        ]
    return datas, headers


def test_verify_digests_bulk_matches_reference(ref):
    datas, headers = _headers_and_datas()
    got = verify_digests_bulk(datas, headers, device="cpu")
    want = ref.checksum.verify_digests_bulk(datas, headers, interpret=True)
    one = [verify_digest(d, h) for d, h in zip(datas, headers)]
    assert got == want == one
    assert one == [ref.checksum.verify_digest(d, h)
                   for d, h in zip(datas, headers)]
    assert any(got) and not all(got)
    with pytest.raises(ValueError):
        verify_digests_bulk(datas, headers[:-1], device="cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, ref):
    """One gzip and one uncompressed shard; the reference's index (saved
    as ``.cdx``) and the port's own build of it."""
    d = tmp_path_factory.mktemp("torch_verify")
    paths = []
    for i, comp in enumerate(["gzip", "none"]):
        p = str(d / f"s{i}.warc{'.gz' if comp == 'gzip' else ''}")
        write_corpus(p, CorpusSpec(n_pages=8, seed=90 + i), comp)
        paths.append(p)
    ref_index = ref.index.build_index(paths)
    ref_index.save(str(d / "ref.cdx"))
    return paths, ref_index, P.build_index(paths, device="cpu"), d


def _broken(index, load, rows, bit_rows):
    """A copy of ``index`` with ``rows``' digests and ``bit_rows``'
    first signature word flipped."""
    out = load()
    out.digest = out.digest.copy()
    out.digest[rows] ^= 1
    out.signatures = out.signatures.copy()
    out.signatures[bit_rows, 0] ^= np.uint64(1)
    return out


def test_verify_index_matches_reference(corpus, ref, tmp_path):
    paths, ref_index, port_index, d = corpus
    n = len(port_index)
    loaded = P.CdxIndex.load(str(d / "ref.cdx"))  # the reference's file
    flips, bits = [1, n // 2, n - 1], [3, n // 3]
    cases = [
        (port_index, ref_index),
        (loaded, ref_index),
        (_broken(port_index, lambda: P.CdxIndex.load(str(d / "ref.cdx")),
                 flips, bits),
         _broken(ref_index,
                 lambda: ref.index.CdxIndex.load(str(d / "ref.cdx")),
                 flips, bits)),
    ]
    for mine, theirs in cases:
        for sigs in (False, True):
            got = P.verify_index(mine, check_signatures=sigs, device="cpu")
            want = ref.index.verify_index(theirs, check_signatures=sigs)
            assert got == want and len(got) == n
    broken = cases[2][0]
    digest_only = P.verify_index(broken, device="cpu")
    assert [i for i, ok in enumerate(digest_only) if not ok] == flips
    with_sigs = P.verify_index(broken, check_signatures=True, device="cpu")
    assert [i for i, ok in enumerate(with_sigs) if not ok] == sorted(
        flips + bits)
    assert P.verify_index(broken, limit=2, device="cpu") == [True, False]
    # a signature geometry the fused kernel does not cover (192 bits):
    # digests stay on the adler32 kernel, signatures on the host
    odd = ref.index.build_index(paths[:1], sig_bits=192)
    odd.save(str(tmp_path / "odd.cdx"))
    odd_port = P.CdxIndex.load(str(tmp_path / "odd.cdx"))
    assert P.verify_index(odd_port, check_signatures=True, device="cpu") \
        == ref.index.verify_index(odd, check_signatures=True) \
        == [True] * len(odd)


def test_verify_digests_on_read_matches_reference(corpus, ref, tmp_path):
    paths, _, port_index, _ = corpus
    # an uncompressed shard with one response body byte changed in place:
    # its block and payload digests must fail, every other record pass
    raw = bytearray(generate_warc(CorpusSpec(n_pages=4, seed=5), "none"))
    at = raw.index(b"</html>")
    raw[at + 2] ^= 0x20
    bad = tmp_path / "bad.warc"
    bad.write_bytes(bytes(raw))
    for path in [*paths, str(bad)]:
        mine = [(r.stream_offset, r.verified_block_digest,
                 r.verified_payload_digest)
                for r in FastWARCIterator(path, verify_digests=True)]
        theirs = [(r.stream_offset, r.verified_block_digest,
                   r.verified_payload_digest)
                  for r in ref.fastwarc.FastWARCIterator(
                      path, verify_digests=True)]
        assert mine == theirs
        assert any(b is not None for _, b, _ in mine)
        assert any(p is not None for _, _, p in mine)
        if path == str(bad):
            assert [o for o, b, _ in mine if b is False] == \
                [o for o, _, p in mine if p is False] != []
        else:
            assert all(b is not False and p is not False
                       for _, b, p in mine)
        for off, b, p in mine[:6]:
            rec = read_record_at(path, off, verify_digests=True)
            assert (rec.verified_block_digest,
                    rec.verified_payload_digest) == (b, p)
    plain = next(iter(FastWARCIterator(paths[0])))
    assert plain.verified_block_digest is None
    row = int(np.flatnonzero(port_index.rtype == 4)[0])  # a response
    with P.RandomAccessReader(paths[int(port_index.shard_id[row])],
                              verify_digests=True) as reader:
        rec = reader.read(int(port_index.offset[row]))
    assert rec.verified_block_digest is True
    assert rec.verified_payload_digest is True


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
def test_cuda_adler32_matches_plain(tmp_path):
    _need_gpu()
    # the kernel module (the package's ``adler32`` is the checksum function)
    mod = importlib.import_module("repro_torch.kernels.adler32.adler32")

    rng = np.random.default_rng(7)
    for rows, width in ((1, 2048), (5, 6144), (64, 65_536)):
        m = np.zeros((rows, width), np.uint8)
        for r in range(rows):
            n = int(rng.integers(0, width + 1))
            m[r, :n] = rng.integers(0, 256, n, dtype=np.uint8)
        m[0] = 0xFF  # the largest T of every block
        x = torch.from_numpy(m).cuda()
        before = mod.launches
        got = mod.adler32_partials_batch(x)
        torch.cuda.synchronize()
        assert mod.launches == before + 1
        for g, w in zip(got, mod.adler32_plain(x)):
            assert torch.equal(g, w)
    with pytest.raises(ValueError):  # not a multiple of 2048
        mod.adler32_partials_batch(torch.zeros((2, 1024), dtype=torch.uint8,
                                               device="cuda"))
    bufs = _payloads(8)
    np.testing.assert_array_equal(adler32_batch(bufs, device="cuda"),
                                  adler32_batch(bufs, device="cpu"))
    # a 192-bit signature geometry is not covered by the digest_sig kernel:
    # like build_index, verify refuses it on the GPU instead of moving the
    # signature check to the host
    path = str(tmp_path / "one.warc")
    write_corpus(path, CorpusSpec(n_pages=2, seed=3), compression="none")
    built = P.build_index([path], device="cuda")
    cols = {name: getattr(built, name) for name, _ in P.cdx._COLUMNS}
    cols["signatures"] = np.ascontiguousarray(built.signatures[:, :3])
    odd = P.CdxIndex.from_columns(
        cols, built.uri_heap, built.mime_heap,
        shard_paths=built.shard_paths, shard_kinds=built.shard_kinds,
        sig_bits=192, sig_ngram=built.sig_ngram,
        sig_hashes=built.sig_hashes)
    assert P.verify_index(odd, device="cuda") == [True] * len(odd)
    with pytest.raises(ValueError, match="does not cover"):
        P.verify_index(odd, check_signatures=True, device="cuda")
