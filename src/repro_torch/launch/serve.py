"""Serving CLI: restore a checkpoint and serve batched requests.

Serves a checkpoint that the reference's trainer wrote
(``repro.train.checkpoint``) through the port's ``ServeEngine``, with
attention on the flash-attention kernel when ``--device cuda``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --ckpt-dir /path/ckpts \\
        --arch fastwarc_lm [--reduced] [--device cuda|cpu] \\
        --prompt "the web " --prompt "..."
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_spec
from repro_torch.models.transformer import params_from_jax
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import checkpoint as ckpt


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="fastwarc_lm")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--prompt", action="append", default=[])
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    spec = get_spec(args.arch)
    cfg = spec.reduced if args.reduced else spec.config
    tree, extras = ckpt.restore(args.ckpt_dir)
    params = params_from_jax(tree, device=args.device)
    print(f"restored step {extras.get('step', '?')} from {args.ckpt_dir}")

    engine = ServeEngine(cfg, params, batch_size=args.batch_size,
                         max_seq=args.max_seq, temperature=args.temperature,
                         device=args.device)
    prompts = args.prompt or ["the web archive "]
    requests = [Request(p.encode(), max_new_tokens=args.max_new_tokens)
                for p in prompts]
    for r in engine.serve(requests):
        print(f"\n>>> {r.prompt.decode()!r}\n{r.text.decode('utf-8', 'replace')}")
    s = engine.stats
    print(f"\n{s['tokens_generated']} tokens, "
          f"{s['tokens_generated']/max(s['decode_s'],1e-9):.1f} tok/s")


if __name__ == "__main__":
    main()
