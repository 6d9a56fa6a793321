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
    q, k, v = _qkv((1, 4, 2, 128, 128, 64), 7)
    jdt = getattr(ref.jnp, dtype)
    want = ref.flash(*(ref.jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                     causal=True)
    assert want.dtype == jdt
    # the port sees the same bf16-rounded inputs
    rounded = [np.array(ref.jnp.asarray(a).astype(jdt).astype(
        ref.jnp.float32)) for a in (q, k, v)]
    got = _port(*rounded, dtype=getattr(torch, dtype))
    np.testing.assert_allclose(got, np.asarray(want.astype(ref.jnp.float32)),
                               rtol=tol, atol=tol if dtype == "bfloat16"
                               else 1e-5)


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
    prefill Sq = Sk = 37 and decode Sq = 1 over Sk = 300."""
    for i, shape in enumerate([(2, 6, 2, 37, 37, 64), (3, 12, 4, 1, 300, 64),
                               (1, 4, 2, 5, 77, 128)]):
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
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 4, 2, 8, 8, 32), 3))
    before = KERNEL.launches
    # any head dim runs on the CPU (the kernel takes 64 and 128)
    torch.testing.assert_close(flash_attention(q, k, v),
                               attention_plain(q, k, v))
    assert KERNEL.launches == before  # no launch for a CPU tensor
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


@pytest.mark.cuda
def test_cuda_flash_matches_plain():
    """The CUDA kernel against its plain version on the card: GQA, MQA,
    causal and not, ragged Sq/Sk, decode over strided cache views, fully
    masked rows, f32 and bf16, D 64 and 128; one launch a call."""
    _need_gpu()
    for i, (shape, causal, dtype, tol) in enumerate([
            ((1, 4, 2, 128, 128, 64), True, torch.float32, 1e-4),
            ((2, 12, 4, 37, 37, 64), True, torch.float32, 1e-4),
            ((2, 12, 4, 37, 37, 64), False, torch.float32, 1e-4),
            ((3, 12, 4, 1, 300, 64), True, torch.float32, 1e-4),
            ((1, 4, 1, 256, 128, 128), True, torch.float32, 1e-4),
            ((1, 16, 8, 200, 200, 128), True, torch.bfloat16, 2e-2)]):
        q, k, v = (torch.from_numpy(a).to(dtype).cuda()
                   for a in _qkv(shape, 60 + i))
        before = KERNEL.launches
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert KERNEL.launches == before + 1
        want = attention_plain(q, k, v, causal=causal)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol if dtype == torch.bfloat16
                                   else 1e-5)
    # decode over a cache view: strided head axis, Sk = length + 1
    cache = torch.randn((2, 4, 64, 64), device="cuda")
    q = torch.randn((2, 12, 1, 64), device="cuda")
    for length in (0, 17, 63):
        kv = cache[:, :, :length + 1]
        torch.testing.assert_close(flash_attention(q, kv, kv),
                                   attention_plain(q, kv, kv), rtol=1e-4,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*(torch.zeros((1, 2, 4, 32), device="cuda"),) * 3)
