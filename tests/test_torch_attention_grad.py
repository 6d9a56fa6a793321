"""Attention's gradient: ``repro_torch``'s plain backward and its autograd
path vs ``jax.grad`` of the reference's ``chunked_attention``.

The reference has no backward kernel; it differentiates its jnp
``chunked_attention`` under XLA. The same numpy-seeded q, k, v and
output gradient go through ``jax.grad`` of ``sum(chunked_attention(q, k,
v) * dO)`` and through the port: ``attention_backward_plain`` fed with
``attention_plain``'s output and log-sum-exp, and autograd through
``flash_attention`` (its CPU path), over GQA, D = 16/32/64, causal with
Sq = Sk and Sq < Sk, and non-causal. Tolerance: rtol 1e-4 / atol 2e-5
(the reference sums in float32, the port's plain version in float64).
A float64 ``gradcheck`` holds the autograd Function to finite
differences, rows with no key included. The ``cuda`` test holds the
backward kernel (and the forward's lse path) against the plain versions
on the card and skips without a GPU.
"""
import importlib
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    FlashAttentionFn, attention_backward_plain, attention_plain,
    flash_attention)
from repro_torch.kernels.flash_attention.ref import LSE_EMPTY

BWD = importlib.import_module("repro_torch.kernels.flash_attention.backward")
FWD = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")
RTOL, ATOL = 1e-4, 2e-5
# B, H, Hkv, Sq, Sk, D, causal
CASES = [
    (2, 4, 2, 64, 64, 16, True),
    (1, 6, 2, 48, 80, 32, True),    # Sq < Sk: bottom-right diagonal
    (1, 4, 1, 40, 40, 64, True),    # MQA
    (1, 4, 2, 32, 48, 32, False),
]


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    from repro.models.attention import chunked_attention

    return SimpleNamespace(jax=jax, jnp=jnp, attn=chunked_attention)


def _inputs(case, seed, dtype=np.float32):
    B, H, Hkv, Sq, Sk, D, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in
            ((B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D), (B, H, Sq, D))]


@pytest.mark.parametrize("i", range(len(CASES)))
def test_backward_matches_jax_grad(ref, i):
    case = CASES[i]
    causal = case[-1]
    q, k, v, do = _inputs(case, 100 + i)

    def loss(q, k, v):  # one case through the chunked scan
        out = ref.attn(q, k, v, causal=causal, chunk=32 if i == 1 else 1024)
        return ref.jnp.sum(out * do)

    want = ref.jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = attention_plain(tq, tk, tv, causal=causal, return_lse=True)
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    plain = attention_backward_plain(tq, tk, tv, out, lse, tdo, causal)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(
        (flash_attention(*leaves, causal=causal) * tdo).sum(), leaves)
    for name, w, p, a in zip("qkv", want, plain, auto):
        np.testing.assert_allclose(p.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d{name} plain")
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d{name} autograd")


def test_gradcheck_and_dispatch():
    """float64 gradcheck of the Function (rows with no key, Sq < Sk,
    non-causal); no grad keeps the inference path; bf16 with grad
    raises."""
    for case in [(1, 2, 1, 7, 3, 8, True), (1, 2, 1, 5, 9, 8, True),
                 (1, 2, 1, 6, 6, 8, False)]:
        q, k, v, _ = (torch.from_numpy(a).requires_grad_()
                      for a in _inputs(case, 7, np.float64))
        assert torch.autograd.gradcheck(
            lambda q, k, v: flash_attention(q, k, v, causal=case[-1]),
            (q, k, v))
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs((1, 4, 2, 7, 3, 16, True), 8))
    out, lse = attention_plain(q, k, v, return_lse=True)
    assert (lse[:, :, :4] == LSE_EMPTY).all() and (out[:, :, :4] == 0).all()
    dq, dk, dv = attention_backward_plain(q, k, v, out, lse, do, True)
    assert (dq[:, :, :4] == 0).all()
    # the lse is the log of the softmax denominator of the scaled scores
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(),
                     k.double().repeat_interleave(2, 1)) / math.sqrt(16)
    mask = torch.ones(7, 3, dtype=torch.bool).tril(-4)
    want = torch.logsumexp(s.masked_fill(~mask, -math.inf), -1)[:, :, 4:]
    np.testing.assert_allclose(lse[:, :, 4:].numpy(), want.numpy(),
                               rtol=1e-6)
    assert flash_attention(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_()
    assert flash_attention(qg, k, v).grad_fn is not None
    with torch.no_grad():
        assert flash_attention(qg, k, v).grad_fn is None
    with pytest.raises(NotImplementedError, match="bf16"):
        flash_attention(qg.bfloat16(), k.bfloat16(), v.bfloat16())
    assert issubclass(FlashAttentionFn, torch.autograd.Function)


@pytest.mark.cuda
def test_cuda_backward_matches_plain():
    """The backward kernel and the forward's lse path against their plain
    versions on the card (rtol = atol = 1e-4), D = 16/32/64/128, Sq < Sk,
    rows with no key, non-causal; then autograd through
    ``flash_attention`` launches both kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cases = [(2, 12, 4, 256, 256, 64, True), (2, 4, 2, 96, 96, 16, True),
             (2, 4, 2, 100, 100, 32, True), (1, 8, 2, 130, 130, 128, True),
             (1, 6, 2, 70, 150, 64, True), (1, 4, 2, 128, 64, 64, True),
             (1, 4, 2, 64, 90, 64, False)]
    for i, case in enumerate(cases):
        q, k, v, do = (torch.from_numpy(a).cuda()
                       for a in _inputs(case, 200 + i))
        causal = case[-1]
        out, lse = FWD.flash_attention_fwd_lse(q, k, v, causal=causal)
        o_p, lse_p = attention_plain(q, k, v, causal=causal, return_lse=True)
        got = BWD.flash_attention_backward(q, k, v, out, lse, do,
                                           causal=causal)
        want = attention_backward_plain(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, o_p, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    q, k, v, do = (torch.from_numpy(a).cuda().requires_grad_()
                   for a in _inputs(cases[0], 300))
    f0, b0, c0 = FWD.launches, BWD.launches, BWD.cuda_launches
    grads = torch.autograd.grad((flash_attention(q, k, v) * do).sum(),
                                (q, k, v))
    # one backward call: Δ, dK/dV and dQ, as the C entry point counts them
    assert (FWD.launches - f0, BWD.launches - b0,
            BWD.cuda_launches - c0) == (1, 1, 3)
    want = attention_backward_plain(q, k, v, *attention_plain(
        q, k, v, return_lse=True), do.detach(), True)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
