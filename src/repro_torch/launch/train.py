"""Training entry point: WARC pipeline → train step on the card → checkpoints.

The port of the reference's ``repro.launch.train``: the token loader
(:mod:`repro_torch.data.loader`, its exact-resume cursor stored in each
checkpoint), the train step (:mod:`repro_torch.train.step`: autograd
through the flash-attention kernel and its backward kernel, AdamW), async
checkpoints every ``ckpt_every`` steps in the reference's format, and the
straggler monitor with an early checkpoint on sustained slowdown.
Parameters are initialised from a ``torch.Generator`` seeded 0 (the port
does not reproduce ``jax.random``'s bits; a checkpoint carries weights
across). TF32 stays off: the config is f32.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --shards a.warc.gz ... \\
        [--steps 200 --batch 32 --seq-len 1024 --ckpt-dir DIR --reduced \\
         --workers 2] --device cuda|cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_spec
from repro_torch.data.loader import WarcTokenLoader, split_batch
from repro_torch.models import transformer as tf_mod
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.elastic import StragglerMonitor
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step

__all__ = ["main", "train_lm"]


def train_lm(
    *,
    arch: str = "fastwarc_lm",
    shards: list[str],
    steps: int = 200,
    batch: int = 8,
    seq_len: int = 512,
    lr: float = 3e-4,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    host_id: int = 0,
    n_hosts: int = 1,
    reduced: bool = False,
    log_every: int = 10,
    workers: int = 0,
    device: "str | torch.device" = "cuda",
) -> dict:
    """Train ``arch`` on ``shards``; resumes from the latest checkpoint in
    ``ckpt_dir``. ``workers > 0`` parses the shards in that many worker
    processes. Returns ``final_loss``, ``first_loss``, ``steps``,
    ``tokens_per_s`` and ``straggler_events``, as the reference does,
    and also ``losses`` and ``step_s``: each step's loss and wall time
    (batch fetch, step and loss read) in this run."""
    dev = resolve_device(device)
    spec = get_spec(arch)
    cfg = spec.reduced if reduced else spec.config
    loader = WarcTokenLoader(shards, batch=batch, seq_len=seq_len,
                             host_id=host_id, n_hosts=n_hosts,
                             workers=workers)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps,
                          warmup_steps=max(steps // 20, 5))

    def loss_fn(params, batch_arrs):
        return tf_mod.loss_fn(params, batch_arrs["tokens"],
                              batch_arrs["labels"], cfg)

    step_fn = make_train_step(loss_fn, opt_cfg)

    start_step = 0
    state = init_train_state(tf_mod.init_params(
        cfg, generator=torch.Generator().manual_seed(0), device=dev))
    if ckpt_dir is not None and ckpt.latest_step(ckpt_dir) is not None:
        state, extras = ckpt.restore(ckpt_dir, state)
        loader.restore(extras["loader"])
        start_step = extras["step"]
        print(f"resumed from step {start_step}")

    saver = ckpt.AsyncCheckpointer()
    monitor = StragglerMonitor()
    losses, step_s = [], []
    it = iter(loader)
    t_train0 = time.perf_counter()
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        rows = next(it)
        inputs, labels = split_batch(rows)
        state, metrics = step_fn(state, {"tokens": inputs, "labels": labels})
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.perf_counter() - t0
        step_s.append(dt)
        slow = monitor.observe(step, dt)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}  {dt*1e3:.0f} ms"
                  + ("  [straggler]" if slow else ""))
        want_ckpt = ckpt_dir is not None and (
            (step + 1) % ckpt_every == 0
            or monitor.should_checkpoint_early())
        if want_ckpt:
            saver.save(ckpt_dir, step + 1, state,
                       extras={"step": step + 1, "loader": loader.state()})
    saver.wait()
    loader.close()
    wall = time.perf_counter() - t_train0
    tokens = (steps - start_step) * batch * seq_len
    return {"final_loss": losses[-1] if losses else float("nan"),
            "first_loss": losses[0] if losses else float("nan"),
            "steps": steps, "tokens_per_s": tokens / wall,
            "straggler_events": len(monitor.events),
            "losses": losses, "step_s": step_s}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="fastwarc_lm")
    ap.add_argument("--shards", nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--workers", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    stats = train_lm(arch=args.arch, shards=args.shards, steps=args.steps,
                     batch=args.batch, seq_len=args.seq_len, lr=args.lr,
                     ckpt_dir=args.ckpt_dir, reduced=args.reduced,
                     workers=args.workers, device=args.device)
    print(stats)


if __name__ == "__main__":
    main()
