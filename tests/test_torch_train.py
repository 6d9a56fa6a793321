"""Training parity: ``repro_torch``'s loss, gradients, optimizer, gradient
compression, train step, checkpoints and ``train_lm`` vs the JAX
reference.

The reference's own initialised reduced ``fastwarc_lm`` parameters are
carried into the port with ``params_from_jax``; numpy-seeded tokens,
labels (some -1) and gradients go through both packages. Tolerances,
float32 both sides (the port's attention is its plain version in
float64, the reference's ``chunked_attention`` in float32, summed in
another order):

* loss rtol 1e-5; every gradient leaf rtol 2e-4 / atol 2e-6;
* AdamW over 3 steps: parameters and moments rtol 1e-5 / atol 1e-7;
  compact state: int8 momentum within 1 step of its scale (a float32
  difference at a .5 boundary rounds it the other way), bf16 second
  moment rtol 1e-2, the parameters atol 1e-4 (1 % of lr: such a step
  moves the next update by up to lr · scale / √v); ``lr_at`` rtol 1e-6
  on all three schedules;
* error-feedback compression: within one quantisation step;
* a microbatched step (``n_microbatches=2``): loss, grad norm rtol 1e-4,
  the parameters after it rtol 1e-5 / atol 2e-6. The step runs with
  ``eps=1e-3``: Adam's first step moves a parameter by lr · g / (|g| +
  eps), which with the default eps turns the last bits of a gradient
  near 0 into a move of order lr; this eps keeps the update linear in
  the gradient, so the gradient's own tolerance carries through;
* checkpoints: leaves bit-equal in both directions; ``train_lm`` resumed
  from a checkpoint the reference's ``train_lm`` wrote gives the
  reference's own continuation's losses, rtol 1e-4.
"""
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_spec
from repro_torch.data.synth import CorpusSpec, write_corpus
from repro_torch.launch.train import train_lm
from repro_torch.models import transformer as port_tf
from repro_torch.train import checkpoint as port_ckpt
from repro_torch.train import grad_compress as port_gc
from repro_torch.train import optimizer as port_opt
from repro_torch.train.elastic import Heartbeat, HostFailure, StragglerMonitor
from repro_torch.train.step import init_train_state, make_train_step

CFG = get_spec("fastwarc_lm").reduced


@pytest.fixture(scope="module")
def ref():
    import jax

    from repro.configs import get_spec as ref_spec
    from repro.launch.train import train_lm as ref_train_lm
    from repro.models import transformer as tf
    from repro.train import checkpoint, grad_compress, optimizer, step

    cfg = ref_spec("fastwarc_lm").reduced
    params = tf.init_params(jax.random.PRNGKey(0), cfg)
    return SimpleNamespace(jax=jax, tf=tf, cfg=cfg, params=params,
                           tree=jax.tree.map(np.asarray, params),
                           opt=optimizer, gc=grad_compress, step=step,
                           ckpt=checkpoint, train_lm=ref_train_lm)


def _port_params(ref):
    params = port_tf.params_from_jax(ref.tree, device="cpu")
    for p in params.parameters():
        p.requires_grad_(True)
    return params


def _assert_tree(got, want, **tol):
    """``got`` (the port's tree) against ``want`` (the reference's)."""
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, dict):
            _assert_tree(got[key], w, **tol)
        else:
            g = got[key]
            g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64), **tol,
                                       err_msg=str(key))


def _batch(seed, b=2, s=64):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, CFG.vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -1
    labels[1, -3:] = -1
    return tokens, labels


def _grads_like(ref, seed):
    rng = np.random.default_rng(seed)
    return ref.jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 0.1).astype(np.float32),
        ref.tree)


def test_loss_and_grads_match_reference(ref):
    tokens, labels = _batch(0)
    loss_r, grads_r = ref.jax.jit(ref.jax.value_and_grad(
        lambda p, t, l: ref.tf.loss_fn(p, t, l, ref.cfg)))(
        ref.params, tokens, labels)
    params = _port_params(ref)
    assert port_tf.params_to_jax(params).keys() == ref.tree.keys()
    _assert_tree(port_tf.params_to_jax(params), ref.tree, rtol=0, atol=0)
    names, leaves = zip(*params.named_parameters())
    for cfg in (CFG, CFG.scaled(remat=False)):
        loss = port_tf.loss_fn(params, tokens, labels, cfg)
        grads = torch.autograd.grad(loss, leaves)
        np.testing.assert_allclose(loss.item(), float(loss_r), rtol=1e-5)
        _assert_tree(port_tf.stack_named(dict(zip(names, grads))),
                     ref.jax.tree.map(np.asarray, grads_r),
                     rtol=2e-4, atol=2e-6)
    with torch.no_grad():  # the serve path builds no graph
        assert port_tf.loss_fn(params, tokens, labels, CFG).grad_fn is None


def test_optimizer_and_schedules_match_reference(ref):
    for schedule in ("cosine", "linear", "constant"):
        cfg = port_opt.AdamWConfig(schedule=schedule, warmup_steps=10,
                                   total_steps=100, lr=1e-3)
        rcfg = ref.opt.AdamWConfig(schedule=schedule, warmup_steps=10,
                                   total_steps=100, lr=1e-3)
        steps = np.array([0, 1, 5, 10, 37, 99, 100, 150], np.int32)
        want = ref.jax.jit(ref.jax.vmap(lambda s: ref.opt.lr_at(rcfg, s)))(
            steps)
        np.testing.assert_allclose([port_opt.lr_at(cfg, s) for s in steps],
                                   np.asarray(want), rtol=1e-6)
    for compact in (False, True):
        cfg = port_opt.AdamWConfig(warmup_steps=2, total_steps=10, lr=1e-2)
        rcfg = ref.opt.AdamWConfig(warmup_steps=2, total_steps=10, lr=1e-2)
        params = _port_params(ref)
        state = port_opt.init_state(params, compact)
        rparams, rstate = ref.params, ref.opt.init_state(ref.params, compact)
        update = ref.jax.jit(lambda p, g, s: ref.opt.apply_updates(
            p, g, s, rcfg))
        for i in range(3):
            g = _grads_like(ref, 10 + i)
            rparams, rstate, rm = update(rparams, g, rstate)
            named = port_tf.unstack_tree(port_tf.map_tree(
                g, torch.from_numpy))
            params, state, m = port_opt.apply_updates(params, named, state,
                                                      cfg)
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(rm["grad_norm"]), rtol=1e-6)
            np.testing.assert_allclose(m["lr"], float(rm["lr"]), rtol=1e-6)
        _assert_tree(port_tf.params_to_jax(params),
                     ref.jax.tree.map(np.asarray, rparams),
                     rtol=1e-5, atol=1e-4 if compact else 1e-7)
        got = port_opt.opt_state_to_jax(state)
        want = ref.jax.tree.map(np.asarray, rstate)
        assert int(got["step"]) == int(want["step"]) == 3
        if not compact:
            _assert_tree({"m": got["m"], "v": got["v"]},
                         {"m": want["m"], "v": want["v"]},
                         rtol=1e-5, atol=1e-7)
            continue
        _assert_tree(got["m_scale"], want["m_scale"], rtol=1e-5, atol=1e-12)
        _assert_tree(got["m_q"], want["m_q"], rtol=0, atol=1)
        _assert_tree(got["v"], want["v"], rtol=1e-2, atol=1e-9)
        back = port_opt.opt_state_from_jax(want, device="cpu")
        assert {k: v.shape for k, v in back["m_scale"].items()} == \
            {k: v.shape for k, v in state["m_scale"].items()}


def test_grad_compression_and_elastic_match_reference(ref):
    params = _port_params(ref)
    err = port_gc.init_error_state(params)
    rerr = ref.gc.init_error_state(ref.params)
    compress = ref.jax.jit(ref.gc.ef_compress_tree)
    for i in range(3):
        g = _grads_like(ref, 20 + i)
        rout, rerr = compress(g, rerr)
        out, err = port_gc.ef_compress_tree(
            port_tf.unstack_tree(port_tf.map_tree(g, torch.from_numpy)), err)
        step = max(float(np.abs(x).max()) for x in
                   ref.jax.tree.leaves(g)) / 127 * 2
        _assert_tree(port_tf.stack_named(out),
                     ref.jax.tree.map(np.asarray, rout), rtol=0, atol=step)
        _assert_tree(port_tf.stack_named(err),
                     ref.jax.tree.map(np.asarray, rerr), rtol=0, atol=step)
    x = torch.linspace(-3, 5, 101)
    q, s = port_gc.quantize(x)
    rq, rs = ref.gc.quantize(x.numpy())
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(port_gc.dequantize(q, s).numpy(),
                               np.asarray(ref.gc.dequantize(rq, rs)),
                               rtol=1e-6)
    mon = StragglerMonitor()
    for i, t in enumerate([1.0, 1.0, 5.0, 6.0, 7.0, 1.0]):
        mon.observe(i, t)
    assert mon.slow_steps == 3 and mon.should_checkpoint_early()
    clock = [0.0]
    hb = Heartbeat(2, timeout=5, clock=lambda: clock[0])
    hb.ping(0)
    clock[0] = 6.0
    hb.ping(0)
    with pytest.raises(HostFailure):
        hb.check()


def test_microbatched_step_matches_reference(ref):
    tokens, labels = _batch(1, b=4, s=32)
    rcfg = ref.opt.AdamWConfig(warmup_steps=1, total_steps=10, lr=1e-3,
                               eps=1e-3)
    rstep = ref.jax.jit(ref.step.make_train_step(
        lambda p, b: ref.tf.loss_fn(p, b["tokens"], b["labels"], ref.cfg),
        rcfg, n_microbatches=2))
    rstate, rm = rstep(ref.step.init_train_state(ref.params),
                       {"tokens": tokens, "labels": labels})
    step = make_train_step(
        lambda p, b: port_tf.loss_fn(p, b["tokens"], b["labels"], CFG),
        port_opt.AdamWConfig(warmup_steps=1, total_steps=10, lr=1e-3,
                             eps=1e-3),
        n_microbatches=2)
    state = init_train_state(port_tf.params_from_jax(ref.tree, device="cpu"))
    state, m = step(state, {"tokens": tokens, "labels": labels})
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(rm[key]), rtol=1e-4)
    _assert_tree(port_tf.params_to_jax(state["params"]),
                 ref.jax.tree.map(np.asarray, rstate["params"]),
                 rtol=1e-5, atol=2e-6)


def test_checkpoints_restore_across_packages(ref, tmp_path):
    """The port's save read by the reference's restore (compact state,
    bf16 and int8 leaves), the reference's read by the port's, and the
    async writer's rotation."""
    state = init_train_state(port_tf.params_from_jax(ref.tree, device="cpu"),
                             use_grad_compression=True, compact_state=True)
    step = make_train_step(
        lambda p, b: port_tf.loss_fn(p, b["tokens"], b["labels"], CFG),
        port_opt.AdamWConfig(), use_grad_compression=True)
    tokens, labels = _batch(2)
    state, _ = step(state, {"tokens": tokens, "labels": labels})
    port_ckpt.save(str(tmp_path / "p"), 1, state, extras={"step": 1})
    target = ref.step.init_train_state(ref.params, use_grad_compression=True,
                                       compact_state=True)
    got, extras = ref.ckpt.restore(str(tmp_path / "p"), target)
    assert extras == {"step": 1}
    want = port_tf.map_tree(port_ckpt.train_state_tree(state),
                             port_tf.to_numpy)
    flat_got = ref.jax.tree_util.tree_leaves_with_path(got)
    for path, leaf in flat_got:
        node = want
        for key in path:
            node = node[key.key]
        assert np.asarray(leaf).dtype == node.dtype, path
        np.testing.assert_array_equal(np.asarray(leaf), node)

    rstate = ref.step.init_train_state(ref.params)
    rstate["opt"]["m"] = _grads_like(ref, 3)
    rstate["opt"]["step"] = ref.jax.numpy.asarray(5, np.int32)
    ref.ckpt.save(str(tmp_path / "r"), 5, rstate, extras={"loader": [1]})
    fresh = init_train_state(port_tf.init_params(
        CFG, generator=torch.Generator().manual_seed(0), device="cpu"))
    back, extras = port_ckpt.restore(str(tmp_path / "r"), fresh)
    assert extras == {"loader": [1]} and back["opt"]["step"] == 5
    _assert_tree(port_tf.map_tree(port_ckpt.train_state_tree(back),
                                   port_tf.to_numpy),
                 ref.jax.tree.map(np.asarray, rstate), rtol=0, atol=0)
    assert back["params"] is fresh["params"]  # written in place
    with pytest.raises(ValueError, match="mismatch"):
        port_ckpt.restore(str(tmp_path / "p"), fresh)

    saver = port_ckpt.AsyncCheckpointer()
    for s in (1, 2, 3):
        saver.save(str(tmp_path / "a"), s, back, extras={"s": s}, keep=2)
    saver.wait()
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == \
        ["step_000000002", "step_000000003"]
    assert port_ckpt.latest_step(str(tmp_path / "a")) == 3


def test_train_lm_resumes_reference_checkpoint(ref, tmp_path):
    """The reference's train_lm writes a step-2 checkpoint of the reduced
    config; the port's train_lm resumed from it gives the losses of the
    reference's own continuation (steps 2 and 3)."""
    shards = []
    for i in range(2):
        p = str(tmp_path / f"t{i}.warc.gz")
        write_corpus(p, CorpusSpec(n_pages=20, seed=90 + i), "gzip")
        shards.append(p)
    kw = dict(shards=shards, batch=2, seq_len=32, reduced=True,
              ckpt_every=2, log_every=100)
    ref.train_lm(steps=2, ckpt_dir=str(tmp_path / "a"), **kw)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    want = ref.train_lm(steps=4, ckpt_dir=str(tmp_path / "a"), **kw)
    got = train_lm(steps=4, ckpt_dir=str(tmp_path / "b"), device="cpu", **kw)
    for key in ("first_loss", "final_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    assert got["steps"] == want["steps"] == 4
    assert set(want) <= set(got)  # the port adds per-step losses, times
    assert len(got["losses"]) == len(got["step_s"]) == 2
    assert got["losses"][-1] == got["final_loss"]
