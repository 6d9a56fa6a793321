"""LM serving parity: ``repro_torch``'s transformer, decode step, serving
engine, checkpoint restore and configs vs the JAX reference.

The reference's own initialised parameters (``init_params(PRNGKey(0),
fastwarc_lm REDUCED)``) are carried into the port with
``params_from_jax``; numpy-seeded tokens go through both. Logits agree
within rtol/atol 1e-4 (float32; the port's attention is the flash
kernel's plain version, the reference's ``chunked_attention`` or its
masked decode softmax, summed in another order); greedy tokens and the
KV cache agree as well. The ``cuda`` test holds the card's forward and
engine against the CPU's and skips without a GPU.
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

from repro_torch.configs import ARCH_IDS, get_spec
from repro_torch.models import transformer as port_tf
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import checkpoint as port_ckpt

ROOT = Path(__file__).resolve().parents[1]
CFG = get_spec("fastwarc_lm").reduced
PROMPTS = [(b"the web archive ", 6), (b"nginx/1.2", 4), (b"x", 5)]


@pytest.fixture(scope="module")
def ref():
    """The reference's LM stack and its initialised reduced parameters
    (imported here, not at module level, so the ``cuda`` test also runs
    where JAX is absent)."""
    import jax

    from repro.configs import get_spec as ref_spec
    from repro.models import transformer as tf
    from repro.serve import engine
    from repro.train import checkpoint
    from repro.train.step import init_train_state

    cfg = ref_spec("fastwarc_lm").reduced
    params = tf.init_params(jax.random.PRNGKey(0), cfg)
    return SimpleNamespace(
        jax=jax, tf=tf, engine=engine, checkpoint=checkpoint,
        init_train_state=init_train_state, spec=ref_spec, cfg=cfg,
        params=params, tree=jax.tree.map(np.asarray, params),
        step=jax.jit(lambda p, c, t: tf.decode_step(p, c, t, cfg)))


@pytest.fixture(scope="module")
def port_params(ref):
    return port_tf.params_from_jax(ref.tree, device="cpu")


def test_forward_matches_reference(ref, port_params):
    tokens = np.random.default_rng(0).integers(0, CFG.vocab, (2, 64))
    want, _ = ref.tf.forward(ref.params, tokens.astype(np.int32), ref.cfg)
    got, aux = port_tf.forward(port_params, torch.from_numpy(tokens), CFG)
    assert got.shape == (2, 64, CFG.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_decode_steps_match_reference(ref, port_params):
    """20 consecutive decode steps: logits every step, then the cache
    contents and length."""
    rng = np.random.default_rng(1)
    cache_r = ref.tf.init_cache(ref.cfg, 2, 32)
    cache_p = port_tf.init_cache(CFG, 2, 32, device="cpu")
    for step in range(20):
        tok = rng.integers(0, CFG.vocab, 2)
        want, cache_r = ref.step(ref.params, cache_r, tok.astype(np.int32))
        got, cache_p = port_tf.decode_step(port_params, cache_p,
                                           torch.from_numpy(tok), CFG)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {step}")
    assert cache_p["length"] == int(cache_r["length"]) == 20
    for key in ("k", "v"):
        np.testing.assert_allclose(cache_p[key].numpy(),
                                   np.asarray(cache_r[key]), rtol=1e-4,
                                   atol=1e-5)
        assert not cache_p[key][:, :, :, 20:].any()


def _serve(engine_cls, request_cls, params, cfg, **kw):
    engine = engine_cls(cfg, params, batch_size=2, max_seq=64, **kw)
    done = engine.serve([request_cls(p, max_new_tokens=n)
                         for p, n in PROMPTS])
    return done, engine.stats


def test_engine_greedy_matches_reference(ref, port_params):
    """Three requests in batches of two (the second batch pads its slot
    with the first prompt): identical tokens, flags and stats counts."""
    want, want_stats = _serve(ref.engine.ServeEngine, ref.engine.Request,
                              ref.params, ref.cfg, temperature=0.0)
    got, stats = _serve(ServeEngine, Request, port_params, CFG,
                        temperature=0.0, device="cpu")
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert [r.done for r in got] == [r.done for r in want]
    assert [r.text for r in got] == [r.text for r in want]
    for key in ("requests", "tokens_generated", "batches"):
        assert stats[key] == want_stats[key], key
    assert set(stats) == set(want_stats)


def test_engine_past_a_full_cache_matches_reference(ref, port_params):
    """BOS + prompt longer than ``max_seq``: the reference's decode step
    writes nothing past the buffer and attends over all of it; the port's
    does the same (no "cache is full" raise), and neither engine has a
    step left to generate."""
    reqs = [(b"a" * 16, 4), (b"hi", 4)]
    out = []
    for engine_cls, request_cls, params, cfg, kw in (
            (ref.engine.ServeEngine, ref.engine.Request, ref.params, ref.cfg,
             {}),
            (ServeEngine, Request, port_params, CFG, {"device": "cpu"})):
        engine = engine_cls(cfg, params, batch_size=2, max_seq=16,
                            temperature=0.0, **kw)
        done = engine.serve([request_cls(p, max_new_tokens=n)
                             for p, n in reqs])
        out.append([r.out_tokens for r in done])
    assert out[0] == out[1] == [[], []]
    # one step past the buffer: logits within tolerance, length advanced
    rng = np.random.default_rng(3)
    cache_r = ref.tf.init_cache(ref.cfg, 2, 4)
    cache_p = port_tf.init_cache(CFG, 2, 4, device="cpu")
    for step in range(6):
        tok = rng.integers(0, CFG.vocab, 2)
        want, cache_r = ref.step(ref.params, cache_r, tok.astype(np.int32))
        got, cache_p = port_tf.decode_step(port_params, cache_p,
                                           torch.from_numpy(tok), CFG)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {step}")
    assert cache_p["length"] == int(cache_r["length"]) == 6
    for key in ("k", "v"):
        np.testing.assert_allclose(cache_p[key].numpy(),
                                   np.asarray(cache_r[key]), rtol=1e-4,
                                   atol=1e-5)


def test_engine_first_token_is_forward_argmax(port_params):
    """The reference's prefill criterion (tests/test_serve.py): the first
    generated token == argmax of forward's last-position logits."""
    engine = ServeEngine(CFG, port_params, batch_size=2, max_seq=64,
                         temperature=0.0, device="cpu")
    for prompt, _ in PROMPTS:
        [req] = engine.serve([Request(prompt, max_new_tokens=1)])
        ids = np.concatenate(([1], np.frombuffer(prompt, np.uint8) + 3))
        logits, _ = port_tf.forward(port_params, torch.from_numpy(ids)[None],
                                    CFG)
        assert req.out_tokens == [int(logits[0, -1].argmax())]


def test_engine_sampling_is_seeded(port_params):
    """Temperature > 0 draws from a seeded torch.Generator: the same seed
    gives the same tokens (not the reference's bits), all in the vocab."""
    runs = [_serve(ServeEngine, Request, port_params, CFG, temperature=0.8,
                   seed=s, device="cpu")[0] for s in (3, 3)]
    a, b = ([r.out_tokens for r in run] for run in runs)
    assert a == b and all(0 <= t < CFG.vocab for r in a for t in r)
    for out, (_, budget) in zip(a, PROMPTS):  # budget spent, or EOS
        assert len(out) == budget or out[-1] == 2


def test_checkpoint_restore_and_serve_cli(ref, tmp_path):
    """A checkpoint the reference's trainer writes (params + Adam state):
    the port restores the params leaves bit-equal, bf16 leaves included,
    and ``python -m repro_torch.launch.serve --device cpu`` serves it."""
    import jax.numpy as jnp

    state = ref.init_train_state(ref.params)
    ref.checkpoint.save(str(tmp_path / "f32"), 7, state, extras={"step": 7})
    tree, extras = port_ckpt.restore(str(tmp_path / "f32"))
    assert extras == {"step": 7}
    assert port_ckpt.latest_step(str(tmp_path / "f32")) == 7
    assert set(tree) == set(ref.tree)
    flat_want = ref.jax.tree_util.tree_leaves_with_path(ref.tree)
    for path, want in flat_want:
        node = tree
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), want)
    bf16 = ref.jax.tree.map(lambda x: x.astype(jnp.bfloat16), ref.params)
    ref.checkpoint.save(str(tmp_path / "bf16"), 3, {"params": bf16})
    tree16, _ = port_ckpt.restore(str(tmp_path / "bf16"))
    got = tree16["layers"]["wq"]["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.uint16).numpy(),
        np.asarray(bf16["layers"]["wq"]["w"]).view(np.uint16))
    with pytest.raises(FileNotFoundError):
        port_ckpt.restore(str(tmp_path / "missing"))

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--ckpt-dir",
         str(tmp_path / "f32"), "--reduced", "--device", "cpu",
         "--max-new-tokens", "4", "--temperature", "0",
         "--prompt", "the web ", "--prompt", "archive"],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "restored step 7" in out.stdout
    assert ">>> 'the web '" in out.stdout and ">>> 'archive'" in out.stdout
    assert "tokens," in out.stdout


def test_init_params_match_reference_layout(ref):
    """Seeded parameters: the reference's leaves, shapes and
    distributions (not its bits); the same seed gives the same weights."""
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    p = port_tf.init_params(CFG, generator=gen(), device="cpu")
    q = port_tf.init_params(CFG, generator=gen(), device="cpu")
    carried = port_tf.params_from_jax(ref.tree, device="cpu")
    shapes = {n: tuple(t.shape) for n, t in carried.named_parameters()}
    assert {n: tuple(t.shape) for n, t in p.named_parameters()} == shapes
    assert sum(t.numel() for t in p.parameters()) == CFG.param_count()
    for (name, a), b in zip(p.named_parameters(), q.parameters()):
        assert torch.equal(a, b) and not a.requires_grad, name
        if name.endswith(".w"):
            assert a.abs().max() <= 1.0 / np.sqrt(a.shape[0]), name
        elif name.endswith("scale"):
            assert torch.equal(a, torch.ones_like(a)), name
    assert abs(float(p.embed.std()) - 0.02) < 0.002
    # the reduced MoE config: each layer holds the reference's ``moe``
    # leaves in place of ``mlp``, and the count is the config's
    moe = get_spec("qwen3_moe_30b_a3b").reduced
    m = port_tf.init_params(moe, generator=gen(), device="cpu")
    shapes = {n: tuple(t.shape) for n, t in m.named_parameters()}
    E, d, f = moe.moe_experts, moe.d_model, moe.d_ff
    for i in range(moe.n_layers):
        assert shapes[f"layers.{i}.moe.router.w"] == (d, E)
        assert shapes[f"layers.{i}.moe.gate"] == (E, d, f)
        assert shapes[f"layers.{i}.moe.up"] == (E, d, f)
        assert shapes[f"layers.{i}.moe.down"] == (E, f, d)
    assert not [n for n in shapes if ".mlp." in n]
    assert sum(t.numel() for t in m.parameters()) == moe.param_count()


def test_configs_and_tokenizer_match_reference(ref):
    from repro.data import tokenizer as ref_tok

    from repro_torch.data import tokenizer as tok

    for arch in ARCH_IDS:
        got, want = get_spec(arch), ref.spec(arch)
        assert asdict(got.config) == asdict(want.config)
        assert asdict(got.reduced) == asdict(want.reduced)
        assert [asdict(s) for s in got.shapes] == [asdict(s)
                                                  for s in want.shapes]
        assert (got.arch_id, got.family) == (want.arch_id, want.family)
    assert get_spec("fastwarc-lm") is get_spec("fastwarc_lm")
    assert get_spec("fastwarc_lm").shape("serve_1k").params == {
        "seq_len": 1024, "global_batch": 8}
    with pytest.raises(KeyError):
        get_spec("gatedgcn")  # not carried by the port yet
    text = bytes(range(256)) + b"WARC/1.1\r\n"
    np.testing.assert_array_equal(tok.encode(text), ref_tok.encode(text))
    np.testing.assert_array_equal(tok.encode_document(text),
                                  ref_tok.encode_document(text))
    assert tok.decode(tok.encode_document(text)) == text
    assert tok.VOCAB_SIZE == ref_tok.VOCAB_SIZE == CFG.vocab


def test_engine_records_trace_spans(port_params):
    from repro_torch import obs
    from repro_torch.obs import trace

    prev = trace.enable(True)
    obs.reset()
    try:
        _serve(ServeEngine, Request, port_params, CFG, device="cpu")
        snap = obs.snapshot()
    finally:
        trace.enable(prev)
        obs.reset()
    for span in ("serve.prefill", "serve.decode"):
        assert snap.counter(f"span.{span}.count") == 2  # one a batch
        assert snap.histograms[f"span.{span}_s"]["count"] == 2


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
def test_cuda_forward_and_engine_match_cpu():
    """The card's forward (flash kernel) against the CPU's (plain version)
    with the same seeded weights, and greedy engine tokens equal; the
    kernel launches in both. The reduced config as it is (d_head 32)."""
    _need_gpu()
    import importlib

    kernel = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    cfg = CFG
    assert cfg.d_head == 32
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = port_tf.init_params(cfg, generator=torch.Generator().manual_seed(1))
    cpu = port_tf.init_params(cfg, generator=torch.Generator().manual_seed(1),
                              device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab, (2, 77)))
    before = kernel.launches
    got, _ = port_tf.forward(gpu, tokens.cuda(), cfg)
    torch.cuda.synchronize()
    assert kernel.launches == before + cfg.n_layers
    want, _ = port_tf.forward(cpu, tokens, cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    before = kernel.launches
    a, _ = _serve(ServeEngine, Request, gpu, cfg)
    b, _ = _serve(ServeEngine, Request, cpu, cfg, device="cpu")
    assert kernel.launches > before
    assert [r.out_tokens for r in a] == [r.out_tokens for r in b]
