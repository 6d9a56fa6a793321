"""Attention parity: ``repro_torch``'s flash-attention wrapper and model
pieces vs the JAX reference.

The same numpy-seeded inputs go through the reference (its Pallas
``flash_attention`` in interpret mode, as ``tests/test_kernels.py`` runs
it, and its jnp ``attention_ref``/``chunked_attention``/RoPE/norms) and
through the port on the CPU, where ``flash_attention`` takes its plain
version. Tolerances are the reference's own kernel-test ones: rtol 1e-4 /
atol 1e-5 in float32, 2e-2 in bfloat16 (the inputs are rounded to bf16
alike; the sums run in another order). The CUDA kernel itself is held
against the plain version by the ``cuda`` test, which skips without a
GPU and needs no JAX.
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention)
from repro_torch.models import attention as port_attn
from repro_torch.models import common as port_common

# the kernel module (the package's ``flash_attention`` name is the wrapper)
KERNEL = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")
# the reference's flash-attention test shapes (tests/test_kernels.py)
SHAPES = [
    # B, H, Hkv, Sq, Sk, D
    (1, 4, 2, 128, 128, 64),
    (2, 8, 2, 256, 256, 64),
    (1, 4, 1, 128, 128, 128),   # MQA
    (1, 8, 8, 128, 512, 64),    # decode: cache longer than queries
    (1, 4, 4, 384, 384, 64),    # non-power-of-two block count
    # the reduced LM configs' head dims (one Pallas block each)
    (1, 4, 2, 64, 64, 16),
    (2, 4, 1, 32, 64, 32),      # MQA, cache longer than queries
    (1, 16, 2, 128, 128, 128),  # GQA group 8, as Qwen3-30B-A3B's attention
]


@pytest.fixture(scope="module")
def ref():
    """The reference's attention functions (imported here, not at module
    level, so the ``cuda`` test also runs where JAX is absent)."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention as flash
    from repro.kernels.flash_attention.ref import attention_ref
    from repro.models import attention, common

    return SimpleNamespace(jnp=jnp, flash=flash, attention_ref=attention_ref,
                           attention=attention, common=common)


def _qkv(shape, seed, dtype=np.float32):
    B, H, Hkv, Sq, Sk, D = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D)).astype(dtype),
            rng.standard_normal((B, Hkv, Sk, D)).astype(dtype),
            rng.standard_normal((B, Hkv, Sk, D)).astype(dtype))


def _port(q, k, v, causal=True, dtype=torch.float32):
    out = flash_attention(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
                          causal=causal)
    assert out.dtype == dtype and out.device.type == "cpu"
    return out.to(torch.float32).numpy()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas_shape_sweep(ref, causal):
    for i, shape in enumerate(SHAPES):
        q, k, v = _qkv(shape, i)
        want = np.asarray(ref.flash(q, k, v, causal=causal))
        np.testing.assert_allclose(_port(q, k, v, causal), want,
                                   rtol=1e-4, atol=1e-5, err_msg=str(shape))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_flash_matches_pallas_dtypes(ref, dtype, tol):
    jdt = getattr(ref.jnp, dtype)
    for shape in ((1, 4, 2, 128, 128, 64), (1, 4, 2, 64, 64, 32),
                  (1, 4, 2, 64, 64, 16), (1, 16, 2, 128, 128, 128)):
        q, k, v = _qkv(shape, 7)
        want = ref.flash(*(ref.jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                         causal=True)
        assert want.dtype == jdt
        # the port sees the same bf16-rounded inputs
        rounded = [np.array(ref.jnp.asarray(a).astype(jdt).astype(
            ref.jnp.float32)) for a in (q, k, v)]
        got = _port(*rounded, dtype=getattr(torch, dtype))
        np.testing.assert_allclose(
            got, np.asarray(want.astype(ref.jnp.float32)), rtol=tol,
            atol=tol if dtype == "bfloat16" else 1e-5, err_msg=str(shape))


def test_fully_masked_rows_are_zero_as_in_pallas(ref):
    """Causal with Sk < Sq: the first Sq - Sk rows see no key. Pallas
    skips their blocks and writes 0 (denominator 0 -> 1); so does the
    port. The reference's attention_ref gives NaN there."""
    q, k, v = _qkv((1, 4, 2, 256, 128, 64), 11)
    want = np.asarray(ref.flash(q, k, v, causal=True))
    got = _port(q, k, v)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert not got[:, :, :128].any() and not want[:, :, :128].any()
    assert np.abs(got[:, :, 128:]).min() > 0
    assert np.isnan(np.asarray(ref.attention_ref(q, k, v))).any()


def test_ragged_shapes_match_reference(ref):
    """Shapes no Pallas block divides (the reference's wrapper falls back
    to attention_ref for them; the port's kernel takes them directly):
    prefill Sq = Sk = 37 and decode Sq = 1 over Sk = 300, at GQA group 3
    and at group 8 with D = 128 (Qwen3-30B-A3B's decode)."""
    for i, shape in enumerate([(2, 6, 2, 37, 37, 64), (3, 12, 4, 1, 300, 64),
                               (1, 4, 2, 5, 77, 128),
                               (1, 16, 2, 1, 300, 128)]):
        q, k, v = _qkv(shape, 20 + i)
        for causal in (True, False):
            got = _port(q, k, v, causal)
            for name, want in (
                    ("attention_ref", ref.attention_ref(q, k, v,
                                                        causal=causal)),
                    ("chunked_attention", ref.attention.chunked_attention(
                        q, k, v, causal=causal, chunk=64))):
                np.testing.assert_allclose(
                    got, np.asarray(want), rtol=1e-4, atol=1e-5,
                    err_msg=f"{shape} causal={causal} vs {name}")


def test_chunked_attention_matches_reference(ref):
    """The port's chunked_attention (kept for parity, off the card's path)
    against the reference's, over one and several chunks, padded last
    chunk included."""
    for i, (shape, chunk) in enumerate([((1, 4, 2, 64, 64, 32), 128),
                                        ((2, 4, 2, 100, 100, 32), 32),
                                        ((1, 6, 3, 1, 90, 64), 16)]):
        q, k, v = _qkv(shape, 40 + i)
        for causal in (True, False):
            want = ref.attention.chunked_attention(q, k, v, causal=causal,
                                                   chunk=chunk)
            got = port_attn.chunked_attention(
                *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                chunk=chunk)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-5)


def test_rope_rmsnorm_swiglu_match_reference(ref):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 9, 32)).astype(np.float32)
    for positions in (np.arange(9, dtype=np.int32),
                      rng.integers(0, 5000, (2, 9)).astype(np.int32)):
        for theta in (10_000.0, 1_000_000.0):
            want = ref.attention.apply_rope(ref.jnp.asarray(x),
                                            ref.jnp.asarray(positions), theta)
            got = port_attn.apply_rope(torch.from_numpy(x),
                                       torch.from_numpy(positions), theta)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)
    h = rng.standard_normal((3, 5, 48)).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    want = ref.common.rmsnorm({"scale": ref.jnp.asarray(scale)},
                              ref.jnp.asarray(h))
    got = port_common.rmsnorm(port_common.RMSNorm(torch.from_numpy(scale)),
                              torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    w = {n: (rng.standard_normal(s) * 0.1).astype(np.float32) for n, s in
         (("gate", (48, 64)), ("up", (48, 64)), ("down", (64, 48)))}
    want = ref.common.swiglu({n: {"w": ref.jnp.asarray(a)}
                              for n, a in w.items()}, ref.jnp.asarray(h))
    mlp = port_common.SwiGLU(*(port_common.Dense(torch.from_numpy(w[n]))
                               for n in ("gate", "up", "down")))
    np.testing.assert_allclose(port_common.swiglu(mlp, torch.from_numpy(h))
                               .numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_wrapper_checks_and_cpu_takes_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 4, 2, 8, 8, 48), 3))
    before = KERNEL.launches
    # any head dim runs on the CPU (the kernel takes 16, 32, 64 and 128)
    torch.testing.assert_close(flash_attention(q, k, v),
                               attention_plain(q, k, v))
    assert KERNEL.launches == before  # no launch for a CPU tensor
    assert KERNEL.HEAD_DIMS == (16, 32, 64, 128)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="dtypes differ"):
        flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="differ"):
        flash_attention(q, k[:, :, :4], v)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _check_cuda(shape, causal, dtype, seed, kv=None):
    """One launch on the card, held against the plain version (f32 at
    rtol 1e-4 / atol 1e-5, bf16 at 2e-2); returns the kernel's output."""
    q = torch.from_numpy(_qkv(shape, seed)[0]).to(dtype).cuda()
    if kv is None:
        kv = [torch.from_numpy(a).to(dtype).cuda()
              for a in _qkv(shape, seed)[1:]]
    before = KERNEL.launches
    got = flash_attention(q, *kv, causal=causal)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    want = attention_plain(q, *kv, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol if dtype == torch.bfloat16 else 1e-5,
                               msg=lambda m: f"{shape} {dtype}: {m}")
    return got, want


@pytest.mark.cuda
def test_cuda_flash_matches_plain():
    """The CUDA kernel against its plain version on the card, every head
    dim in both dtypes: GQA, MQA, causal and not, ragged Sq/Sk, fully
    masked rows, decode over strided cache views; one launch a call."""
    _need_gpu()
    for d in (16, 32, 64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            for i, (shape, causal) in enumerate([
                    ((1, 4, 2, 128, 128, d), True),
                    ((2, 12, 4, 37, 37, d), True),
                    ((2, 12, 4, 37, 37, d), False),
                    ((3, 12, 4, 1, 300, d), True),
                    ((1, 4, 1, 256, 128, d), True)]):
                got, _ = _check_cuda(shape, causal, dtype, 60 + i)
                if causal and shape[3] > shape[4]:  # rows with no key: 0
                    assert not got[:, :, :shape[3] - shape[4]].any()
    # decode over a cache view: strided head axis, Sk = length + 1
    cache = torch.randn((2, 4, 64, 64), device="cuda")
    q = torch.randn((2, 12, 1, 64), device="cuda")
    for length in (0, 17, 63):
        kv = cache[:, :, :length + 1]
        torch.testing.assert_close(flash_attention(q, kv, kv),
                                   attention_plain(q, kv, kv), rtol=1e-4,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*(torch.zeros((1, 2, 4, 48), device="cuda"),) * 3)


@pytest.mark.cuda
def test_cuda_split_kv_decode():
    """The split-KV decode paths ((H / Hkv) * Sq <= 16; f32 on CUDA cores,
    bf16 on tensor cores): one key, a part tile, 1,000 keys (4 splits), Sk
    not a multiple of 64, one pair with fewer tiles than SMs, 16 rows,
    causal rows (Sq = 2), a full cache at max_seq (cache views), f32 and
    bf16; GQA group 8 over 1, 777 and 1,024 keys (the last Qwen3-30B-A3B's
    decode through views of its [8, 4, 1024, 128] cache) and, at batch 1,
    over 8,192 keys (4 pairs: the bf16 decode's most splits); bf16 at
    every head dim for G * Sq of 1, 2, 3, 4, 5, 8 and 16; the same decode
    twice gives the same bits."""
    _need_gpu()
    for dtype in (torch.float32, torch.bfloat16):
        for i, shape in enumerate([(8, 12, 4, 1, 1, 64),
                                   (8, 12, 4, 1, 63, 64),
                                   (8, 12, 4, 1, 1000, 64),
                                   (2, 16, 8, 1, 777, 128),
                                   (1, 1, 1, 1, 100, 32),  # 1 pair, 2 tiles
                                   (2, 4, 2, 3, 200, 16),  # G * Sq = 6
                                   (2, 16, 1, 1, 300, 128),  # 16 rows
                                   (1, 8, 1, 2, 500, 128),  # causal, Sq 2
                                   (8, 32, 4, 1, 1, 128),  # group 8
                                   (2, 32, 4, 1, 777, 128)]):
            _check_cuda(shape, True, dtype, 80 + i)
        # a full cache: every one of max_seq positions, through views
        cache = torch.randn((2, 8, 4, 512, 64), device="cuda").to(dtype)
        kv = [cache[0], cache[1]]
        _check_cuda((8, 12, 4, 1, 512, 64), True, dtype, 90, kv=kv)
        q = torch.randn((8, 16, 1, 128), device="cuda").to(dtype)
        big = torch.randn((2, 8, 8, 2048, 128), device="cuda").to(dtype)
        runs = [flash_attention(q, big[0, :, :, :2000], big[1, :, :, :2000])
                for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])
    # bf16 at every head dim, G * Sq rows (G query heads a KV head, Sq
    # positions) of 1, 2, 3, 4, 5, 8 and 16: Sq = 1 at G = 1, 2, 3, 4, 5,
    # 8, 16; and G = 1 at Sq = 3, G = 4 at Sq = 2
    for d in (16, 32, 64, 128):
        for i, shape in enumerate([(2, 2, 2, 1, 300, d), (2, 4, 2, 1, 300, d),
                                   (2, 3, 1, 1, 300, d), (2, 8, 2, 1, 300, d),
                                   (2, 5, 1, 1, 300, d), (2, 16, 2, 1, 300, d),
                                   (2, 16, 1, 1, 300, d),
                                   (2, 4, 4, 3, 300, d), (2, 8, 2, 2, 300, d)
                                   ]):
            _check_cuda(shape, True, torch.bfloat16, 120 + i)
    # Qwen3-30B-A3B's decode step: q [8, 32, 1, 128] over 1,024 keys of its
    # cache, twice, with equal bits
    cache = torch.randn((2, 8, 4, 1024, 128), device="cuda").to(torch.bfloat16)
    got, _ = _check_cuda((8, 32, 4, 1, 1024, 128), True, torch.bfloat16, 95,
                         kv=[cache[0], cache[1]])
    q = torch.from_numpy(_qkv((8, 32, 4, 1, 1024, 128), 95)[0]).to(
        torch.bfloat16).cuda()
    again = flash_attention(q, cache[0], cache[1])
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    # batch 1 over a long cache: few pairs, many splits
    _check_cuda((1, 32, 4, 1, 8192, 128), True, torch.bfloat16, 96)


@pytest.mark.cuda
def test_cuda_bf16_tensor_core_prefill():
    """The wgmma/TMA path (bf16, (H / Hkv) * Sq > 16): ragged Sq = 37 and
    200, rows with no key (Sk < Sq), GQA and MQA, every head dim; GQA
    group 8 at D = 128 (Qwen3-30B-A3B's attention): Sq = Sk = 200 and
    1,000 (64-row tiles straddling two heads), Sq 256 over Sk 100,
    non-causal, and q as the model passes it (a transpose(1, 2) view); a
    misaligned stride raises instead of reaching TMA."""
    _need_gpu()
    for d in (16, 32, 64, 128):
        for i, (shape, causal) in enumerate([
                ((2, 12, 4, 37, 37, d), True),
                ((1, 16, 8, 200, 200, d), True),
                ((1, 8, 1, 200, 200, d), True),       # MQA
                ((1, 4, 2, 200, 150, d), False),
                ((1, 4, 2, 256, 100, d), True)]):     # 156 rows with no key
            got, _ = _check_cuda(shape, causal, torch.bfloat16, 100 + i)
            if causal and shape[3] > shape[4]:
                assert not got[:, :, :shape[3] - shape[4]].any()
                assert got[:, :, shape[3] - shape[4]:].abs().amax(-1).min() > 0
    for i, (shape, causal) in enumerate([
            ((1, 16, 2, 200, 200, 128), True),
            ((1, 16, 2, 1000, 1000, 128), True),
            ((1, 16, 2, 256, 100, 128), True),      # 156 rows with no key
            ((1, 16, 2, 200, 150, 128), False)]):
        got, _ = _check_cuda(shape, causal, torch.bfloat16, 110 + i)
        if causal and shape[3] > shape[4]:
            assert not got[:, :, :shape[3] - shape[4]].any()
            assert got[:, :, shape[3] - shape[4]:].abs().amax(-1).min() > 0
    # q as attention() passes it: a [B, H, S, D] view of [B, S, H, D]
    qs, ks, vs = _qkv((2, 16, 2, 200, 200, 128), 115)
    q = torch.from_numpy(qs.transpose(0, 2, 1, 3).copy()).to(
        torch.bfloat16).cuda().transpose(1, 2)
    kv = [torch.from_numpy(a).to(torch.bfloat16).cuda() for a in (ks, vs)]
    torch.testing.assert_close(flash_attention(q, *kv).float(),
                               attention_plain(q, *kv).float(), rtol=2e-2,
                               atol=2e-2)
    q = torch.zeros((1, 4, 64, 64), device="cuda", dtype=torch.bfloat16)
    kv = torch.zeros((1, 2, 64, 68), device="cuda",
                     dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="TMA"):
        flash_attention(q, kv, kv)
