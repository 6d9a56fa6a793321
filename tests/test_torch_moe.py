"""MoE serving parity: ``repro_torch``'s ``models/moe.py``, the MoE
transformer, its decode step, the serving engine and the serve CLI, and
the dense ``starcoder2_3b`` / ``qwen25_32b`` configs, vs the JAX
reference.

The reference's own ``moe_init`` / ``init_params`` leaves are carried into
the port (the dispatch cases take the first E of one 16-expert draw);
numpy-seeded inputs go through both. The dispatch is compared through
its internals as well as its output: the reference's chosen
experts (its ``jax.lax.top_k``) and its ``[G, E, C]`` slot table of token
ids (the int32 array it passes to ``shard_hint``) are recorded inside one
jitted call and must equal the port's bit for bit, with the per-expert
counts. Float32 tolerances: out and aux within 1e-5 (the combine sums the
same products in another order), model logits within 1e-4 (the LM tests'
tolerance). The ``cuda`` test holds the card's reduced MoE against the
CPU's and skips without a GPU.
"""
import os
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_spec
from repro_torch.models import moe as port_moe
from repro_torch.models import transformer as port_tf
from repro_torch.models.common import Dense, rmsnorm
from repro_torch.serve import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
MOE_ARCHS = ["qwen3_moe_30b_a3b", "qwen3_moe_235b_a22b"]
DENSE_ARCHS = ["starcoder2_3b", "qwen25_32b"]
PROMPTS = [(b"the web archive ", 6), (b"nginx/1.2", 4), (b"x", 5)]
# an L9 orthogonal array over (E, k, groups, cf): every pair of values of
# any two factors meets in one case
LEVELS = {"E": (4, 8, 16), "k": (1, 2, 4), "groups": (1, 2, 4),
          "cf": (0.5, 1.25, 64.0)}
L9 = [(0, 0, 0, 0), (0, 1, 1, 1), (0, 2, 2, 2), (1, 0, 1, 2), (1, 1, 2, 0),
      (1, 2, 0, 1), (2, 0, 2, 1), (2, 1, 0, 2), (2, 2, 1, 0)]
CASES = [tuple(LEVELS[f][i] for f, i in zip(LEVELS, row)) for row in L9]
# bf16 outputs: both sides round the expert products and the combine to
# bf16 (8 significant bits), in another order; 2^-6 covers a few ulps
BF16_TOL = 2.0 ** -6


@pytest.fixture(scope="module")
def ref():
    """The reference's MoE and LM stack (imported here, not at module
    level, so the ``cuda`` test also runs where JAX is absent)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_spec as ref_spec
    from repro.models import moe, transformer
    from repro.serve import engine
    from repro.train import checkpoint
    from repro.train.step import init_train_state

    # jitted initialisers: one compile each, not one per eager random op
    experts = jax.jit(moe.moe_init, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(0), 16, 8, 16)
    return SimpleNamespace(
        jax=jax, jnp=jnp, moe=moe, tf=transformer, engine=engine,
        checkpoint=checkpoint, init_train_state=init_train_state,
        spec=ref_spec, experts=jax.tree.map(np.asarray, experts),
        init_params=jax.jit(transformer.init_params, static_argnums=1))


def _experts(ref, E, dtype=np.float32):
    """The first ``E`` experts (and router columns) of the reference's
    ``moe_init(d_model=16, d_ff=8, n_experts=16)``, as ``dtype``."""
    t = ref.experts
    leaves = {"router": {"w": t["router"]["w"][:, :E]}, "gate": t["gate"][:E],
              "up": t["up"][:E], "down": t["down"][:E]}
    return ref.jax.tree.map(lambda a: ref.jnp.asarray(a, dtype), leaves)


def _ref_dispatch(ref, p, x, **kw):
    """The reference's ``moe_apply`` in one jitted call: (out, aux, chosen
    experts [G, Tg, k], slot token ids [G, E, C]), the last two recorded
    from its ``jax.lax.top_k`` and ``shard_hint`` calls."""
    jax, moe = ref.jax, ref.moe
    seen = {"topk": [], "hint": []}
    top_k, hint = jax.lax.top_k, moe.shard_hint

    def rec_top_k(a, k):
        out = top_k(a, k)
        seen["topk"].append(out[1])
        return out

    def rec_hint(a, *spec):
        seen["hint"].append(a)
        return hint(a, *spec)

    def run(p, x):
        jax.lax.top_k, moe.shard_hint = rec_top_k, rec_hint
        try:
            out, aux = moe.moe_apply(p, x, **kw)
        finally:
            jax.lax.top_k, moe.shard_hint = top_k, hint
        [ids] = [a for a in seen["hint"] if a.dtype == ref.jnp.int32]
        return out, aux, seen["topk"][0], ids

    return [np.asarray(a) for a in jax.jit(run)(p, x)]


def _port(tree) -> port_moe.MoE:
    t = port_tf.tensor_tree(tree)
    return port_moe.MoE(Dense(t["router"]["w"]), t["gate"], t["up"],
                        t["down"])


def _check_dispatch(ref, p, x, *, top_k, cf, groups, out_tol):
    """Port vs reference on one input: experts, slot token ids and counts
    equal; out and aux within ``out_tol``; returns the port's routing."""
    want, aux_w, experts_w, ids_w = _ref_dispatch(
        ref, p, ref.jnp.asarray(x), top_k=top_k, capacity_factor=cf,
        groups=groups)
    pm = _port(ref.jax.tree.map(np.asarray, p))
    xt = port_tf.tensor_tree({"x": x})["x"]
    kw = dict(top_k=top_k, capacity_factor=cf, groups=groups)
    r = port_moe.moe_route(pm, xt, **kw)
    got, aux = port_moe.moe_apply(pm, xt, **kw)
    case = f"E={pm.gate.shape[0]} k={top_k} groups={groups} cf={cf}"
    np.testing.assert_array_equal(r.experts.numpy(), experts_w, case)
    np.testing.assert_array_equal(r.token_ids.numpy(), ids_w, case)
    E = pm.gate.shape[0]
    counts = np.stack([np.bincount(g.reshape(-1), minlength=E)
                       for g in experts_w])
    np.testing.assert_array_equal(r.counts.numpy(), counts, case)
    np.testing.assert_allclose(got.float().numpy(),
                               want.astype(np.float32), rtol=out_tol,
                               atol=out_tol, err_msg=case)
    np.testing.assert_allclose(float(aux), float(aux_w), rtol=1e-5,
                               atol=1e-6, err_msg=case)
    return r


def test_moe_apply_matches_reference(ref):
    """f32, every pair of E ∈ {4, 8, 16}, k ∈ {1, 2, 4}, groups ∈ {1, 2,
    4}, cf ∈ {0.5, 1.25, 64}: equal experts, slot token ids and counts;
    out and aux within 1e-5. T = 30 where groups = 4 (the reference's
    fallback to 3 groups), else 32; cf 0.5 drops, cf 64 keeps all."""
    drops = {}
    for n, (E, k, groups, cf) in enumerate(CASES):
        T = 30 if groups == 4 else 32
        p = _experts(ref, E)
        x = np.random.default_rng(n).standard_normal((T, 16)).astype(
            np.float32)
        r = _check_dispatch(ref, p, x, top_k=k, cf=cf, groups=groups,
                            out_tol=1e-5)
        assert r.slots.shape[0] == port_moe.num_groups(T, groups)
        drops[cf] = drops.get(cf, 0) + r.dropped
    assert drops[0.5] > 0 and drops[64.0] == 0, drops


def _int_valued(rng, shape, scale):
    """Small integers times a power of two: every product and sum of the
    router's is exact in f32 and bf16, in any order."""
    return (rng.integers(-3, 4, shape) * scale).astype(np.float32)


def test_tied_router_logits_follow_lax_top_k(ref):
    """Duplicated router columns tie exactly: the port keeps
    ``lax.top_k``'s order (the lower expert first), so its selection and
    its drops equal the reference's."""
    jnp = ref.jnp
    rng = np.random.default_rng(7)
    E, d, k = 8, 16, 2
    p = _experts(ref, E)
    w = _int_valued(rng, (d, E), 0.125)
    w[:, 4], w[:, 6], w[:, 7] = w[:, 1], w[:, 1], w[:, 3]
    p = {**p, "router": {"w": jnp.asarray(w)}}
    x = _int_valued(rng, (40, d), 0.25)
    r = _check_dispatch(ref, p, x, top_k=k, cf=1.0, groups=1, out_tol=1e-5)
    probs = r.probs[0]
    kth = probs.gather(-1, r.experts[0][:, k - 1:])
    ties = ((probs == kth).sum(-1) > 1).sum()
    assert ties > 0 and r.dropped > 0, (int(ties), r.dropped)


def test_bf16_exact_router_matches_reference(ref):
    """bf16 parameters and inputs, the router's product exact in any
    summation order: the same experts, slots and counts (ties included);
    outputs within 2^-6."""
    jnp = ref.jnp
    rng = np.random.default_rng(11)
    E, d, k = 8, 16, 2
    p = _experts(ref, E, jnp.bfloat16)
    p = {**p, "router": {"w": jnp.asarray(_int_valued(rng, (d, E), 0.125),
                                          jnp.bfloat16)}}
    x = np.asarray(jnp.asarray(_int_valued(rng, (48, d), 0.25), jnp.bfloat16))
    r = _check_dispatch(ref, p, x, top_k=k, cf=1.25, groups=2,
                        out_tol=BF16_TOL)
    assert r.dropped > 0


def test_plain_version_equals_dispatch():
    """``moe_apply_plain`` (a loop over experts) and ``moe_apply`` choose
    the same experts and keep the same assignments, drops included; out
    within 1e-6 (f32) and aux within 1e-6."""
    gen = torch.Generator().manual_seed(3)
    total_drops = 0
    for n, (E, k, groups, cf) in enumerate(CASES):
        T = 30 if groups == 4 else 64
        p = port_moe.moe_init(16, 8, E, generator=gen)
        x = torch.randn((T, 16), generator=gen)
        kw = dict(top_k=k, capacity_factor=cf, groups=groups)
        r = port_moe.moe_route(p, x, **kw)
        got, aux = port_moe.moe_apply(p, x, **kw)
        want, aux_w, experts, kept = port_moe.moe_apply_plain(p, x, **kw)
        case = f"E={E} k={k} groups={groups} cf={cf}"
        assert torch.equal(r.experts.reshape(T, k), experts), case
        assert torch.equal(r.kept.reshape(T, k), kept), case
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6,
                                   msg=case)
        torch.testing.assert_close(aux, aux_w, rtol=1e-6, atol=1e-6,
                                   msg=case)
        total_drops += r.dropped
    assert total_drops > 0


def _layer0_routing(params, cfg, tokens):
    """The port's routing of layer 0's normalised hidden states."""
    lp = params.layers[0]
    x = params.embed[tokens]
    cos, sin = port_tf.rope_cos_sin(
        torch.arange(tokens.shape[1], device=tokens.device), cfg.d_head,
        cfg.rope_theta)
    h = rmsnorm(lp.ln2, port_tf._attention_block(lp, x, cfg, cos, sin))
    return port_moe.moe_route(lp.moe, h.reshape(-1, cfg.d_model),
                              top_k=cfg.moe_top_k,
                              capacity_factor=cfg.capacity_factor)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reduced_moe_lm_matches_reference(ref, arch):
    """The reduced config with the reference's initialised weights:
    ``forward`` logits and aux within 1e-4 over [2, 64] tokens (layer 0
    drops assignments there), 6 ``decode_step``s (logits every step, then
    the cache), and the engine's greedy tokens equal the reference
    engine's."""
    cfg_r = ref.spec(arch).reduced
    cfg = get_spec(arch).reduced
    params = ref.init_params(ref.jax.random.PRNGKey(0), cfg_r)
    pp = port_tf.params_from_jax(ref.jax.tree.map(np.asarray, params),
                                 device="cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, 64))
    want, aux_w = ref.jax.jit(lambda p, t: ref.tf.forward(p, t, cfg_r))(
        params, tokens.astype(np.int32))
    with torch.inference_mode():
        got, aux = port_tf.forward(pp, torch.from_numpy(tokens), cfg)
        drops = _layer0_routing(pp, cfg, torch.from_numpy(tokens)).dropped
    assert drops > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(aux_w), rtol=1e-4)
    assert float(aux) > 0

    # decode through the reference engine's own jitted step (batch 2,
    # max_seq 64), then the engine itself
    want_engine = ref.engine.ServeEngine(cfg_r, params, batch_size=2,
                                         max_seq=64, temperature=0.0)
    rng = np.random.default_rng(6)
    cache_r = ref.tf.init_cache(cfg_r, 2, 64)
    cache_p = port_tf.init_cache(cfg, 2, 64, device="cpu")
    for step in range(6):
        tok = rng.integers(0, cfg.vocab, 2)
        want, cache_r = want_engine._step(params, cache_r,
                                          tok.astype(np.int32))
        got, cache_p = port_tf.decode_step(pp, cache_p,
                                           torch.from_numpy(tok), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {step}")
    assert cache_p["length"] == int(cache_r["length"]) == 6
    for key in ("k", "v"):
        np.testing.assert_allclose(cache_p[key].numpy(),
                                   np.asarray(cache_r[key]), rtol=1e-4,
                                   atol=1e-5)
    done_w = want_engine.serve([ref.engine.Request(p, max_new_tokens=n)
                                for p, n in PROMPTS])
    engine = ServeEngine(cfg, pp, batch_size=2, max_seq=64, temperature=0.0,
                         device="cpu")
    done = engine.serve([Request(p, max_new_tokens=n) for p, n in PROMPTS])
    assert [r.out_tokens for r in done] == [r.out_tokens for r in done_w]
    assert [r.done for r in done] == [r.done for r in done_w]


def test_params_carry_across_and_counts(ref):
    """``params_from_jax`` → ``params_to_jax`` gives back the reference's
    MoE tree bit for bit; seeded ``init_params`` makes the same leaves,
    shapes and distributions; ``param_count`` / ``active_param_count``
    equal the reference's for every config the port carries."""
    jax = ref.jax
    cfg = get_spec("qwen3_moe_30b_a3b").reduced
    tree = jax.tree.map(np.asarray, ref.init_params(
        jax.random.PRNGKey(1), ref.spec("qwen3_moe_30b_a3b").reduced))
    back = port_tf.params_to_jax(port_tf.params_from_jax(tree, device="cpu"))
    flat_w = jax.tree_util.tree_leaves_with_path(tree)
    flat_g = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert g.dtype == w.dtype and np.array_equal(g, w), path
    assert back["layers"]["moe"]["router"]["w"].shape == (
        cfg.n_layers, cfg.d_model, cfg.moe_experts)

    p = port_tf.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    shapes = {"/".join(k.key for k in path): leaf.shape
              for path, leaf in flat_w}
    got = {"/".join(k.key for k in path): leaf.shape for path, leaf in
           jax.tree_util.tree_leaves_with_path(port_tf.params_to_jax(p))}
    assert got == shapes
    assert sum(t.numel() for t in p.parameters()) == cfg.param_count()
    for i, lp in enumerate(p.layers):
        m = lp.moe
        for name, leaf, bound in (
                ("router", m.router.w, cfg.d_model ** -0.5),
                ("gate", m.gate, cfg.d_model ** -0.5),
                ("up", m.up, cfg.d_model ** -0.5),
                ("down", m.down, cfg.d_ff ** -0.5)):
            assert leaf.abs().max() <= bound, (i, name)
            assert leaf.abs().max() > 0.9 * bound, (i, name)
    for arch in MOE_ARCHS + DENSE_ARCHS + ["internlm2_1_8b", "fastwarc_lm"]:
        for which in ("config", "reduced"):
            c, w = getattr(get_spec(arch), which), getattr(ref.spec(arch),
                                                           which)
            assert asdict(c) == asdict(w)
            assert (c.param_count(), c.active_param_count()) == (
                w.param_count(), w.active_param_count()), (arch, which)
    full = get_spec("qwen3_moe_30b_a3b").config
    assert full.param_count() == 30_532_110_336
    assert full.active_param_count() < full.param_count() // 8


def test_serve_cli_restores_reference_moe_checkpoint(ref, tmp_path):
    """A reduced Qwen3-MoE checkpoint the reference's trainer writes:
    ``python -m repro_torch.launch.serve --arch qwen3_moe_30b_a3b
    --reduced --device cpu`` restores and serves it, with the greedy text
    of the port's engine on the same weights."""
    jax = ref.jax
    cfg_r = ref.spec("qwen3_moe_30b_a3b").reduced
    params = ref.init_params(jax.random.PRNGKey(2), cfg_r)
    ref.checkpoint.save(str(tmp_path), 5, ref.init_train_state(params),
                        extras={"step": 5})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-moe-30b-a3b", "--ckpt-dir", str(tmp_path), "--reduced",
         "--device", "cpu", "--max-new-tokens", "5", "--temperature", "0",
         "--prompt", "the web "], capture_output=True, text=True, env=env,
        timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "restored step 5" in out.stdout
    pp = port_tf.params_from_jax(jax.tree.map(np.asarray, params),
                                 device="cpu")
    [r] = ServeEngine(get_spec("qwen3_moe_30b_a3b").reduced, pp,
                      temperature=0.0, device="cpu").serve(
        [Request(b"the web ", max_new_tokens=5)])
    assert len(r.out_tokens) == 5
    assert ">>> 'the web '\n" + r.text.decode("utf-8", "replace") \
        in out.stdout


def test_dense_configs_match_reference(ref):
    """The reduced ``starcoder2_3b`` (group 3) and ``qwen25_32b``
    (``qkv_bias``, group 5) with the reference's weights: ``forward``
    logits and 4 ``decode_step``s within 1e-4."""
    for arch in DENSE_ARCHS:
        cfg_r, cfg = ref.spec(arch).reduced, get_spec(arch).reduced
        params = ref.init_params(ref.jax.random.PRNGKey(3), cfg_r)
        pp = port_tf.params_from_jax(ref.jax.tree.map(np.asarray, params),
                                     device="cpu")
        assert (cfg.qkv_bias, pp.layers[0].wq.b is not None) == (
            arch == "qwen25_32b",) * 2
        tokens = np.random.default_rng(8).integers(0, cfg.vocab, (2, 40))
        want, _ = ref.jax.jit(lambda p, t: ref.tf.forward(p, t, cfg_r))(
            params, tokens.astype(np.int32))
        with torch.inference_mode():
            got, aux = port_tf.forward(pp, torch.from_numpy(tokens), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4, err_msg=arch)
        assert float(aux) == 0.0
        step = ref.jax.jit(lambda p, c, t: ref.tf.decode_step(p, c, t, cfg_r))
        cache_r = ref.tf.init_cache(cfg_r, 2, 16)
        cache_p = port_tf.init_cache(cfg, 2, 16, device="cpu")
        for i, tok in enumerate(tokens[:, :4].T):
            want, cache_r = step(params, cache_r, tok.astype(np.int32))
            got, cache_p = port_tf.decode_step(pp, cache_p,
                                               torch.from_numpy(tok), cfg)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{arch} step {i}")


@pytest.mark.cuda
def test_cuda_reduced_moe_matches_cpu():
    """The reduced Qwen3-MoE on the card (flash kernel, the dispatch on
    CUDA tensors) against the CPU with the same seeded weights: forward
    logits and aux within 2e-4, greedy engine tokens equal; ``moe_apply``
    equals ``moe_apply_plain`` on the card, drops included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import importlib

    kernel = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_spec("qwen3_moe_30b_a3b").reduced
    cpu = port_tf.init_params(cfg, generator=torch.Generator().manual_seed(1),
                              device="cpu")
    gpu = port_tf.init_params(cfg, generator=torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab, (2, 64)))
    before = kernel.launches
    with torch.inference_mode():
        got, aux = port_tf.forward(gpu, tokens.cuda(), cfg)
        launches = kernel.launches - before
        want, aux_w = port_tf.forward(cpu, tokens, cfg)
        r = _layer0_routing(gpu, cfg, tokens.cuda())
        kw = dict(top_k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor)
        x = torch.randn((128, cfg.d_model), device="cuda")
        d_out, d_aux = port_moe.moe_apply(gpu.layers[0].moe, x, **kw)
        p_out, p_aux, experts, kept = port_moe.moe_apply_plain(
            gpu.layers[0].moe, x, **kw)
    torch.cuda.synchronize()
    assert launches == cfg.n_layers and r.dropped > 0
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(aux.cpu(), aux_w, rtol=2e-4, atol=2e-4)
    route = port_moe.moe_route(gpu.layers[0].moe, x, **kw)
    assert torch.equal(route.experts.reshape(-1, cfg.moe_top_k), experts)
    assert torch.equal(route.kept.reshape(-1, cfg.moe_top_k), kept)
    torch.testing.assert_close(d_out, p_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d_aux, p_aux, rtol=1e-5, atol=1e-6)
    outs = []
    for params, dev in ((gpu, "cuda"), (cpu, "cpu")):
        engine = ServeEngine(cfg, params, batch_size=2, max_seq=64,
                             temperature=0.0, device=dev)
        outs.append([r.out_tokens for r in engine.serve(
            [Request(p, max_new_tokens=n) for p, n in PROMPTS])])
    assert outs[0] == outs[1]
