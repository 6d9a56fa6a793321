"""Batched LM serving engine: prefill + decode with a shared KV cache.

The reference's serving loop on PyTorch: requests are drained into
fixed-size batches, each batch is prefilled token by token into the
cache through :func:`~repro_torch.models.transformer.decode_step`, then
decoded greedily or with temperature until EOS or ``max_new_tokens``.
Every step's attention runs through the flash-attention kernel on the
card.

Two differences from the reference that leave the tokens unchanged:
during prefill the next input of each slot (its prompt's next token, or
the sampled one once its prompt is spent) is chosen on the device from a
padded prompt matrix, so prefill reads nothing back to the host; decode
reads each step's tokens back once, as one list. Sampling draws from a
``torch.Generator`` seeded from ``seed`` (not ``jax.random``'s bits).

With tracing on (``repro_torch.obs.trace.enable()``), each batch records
``serve.prefill`` / ``serve.decode`` span durations — one enabled()
check per batch, zero per-token cost; the device is synchronised at the
end of each, so the split is device time and not enqueue time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.data.tokenizer import BOS_ID, EOS_ID, decode as tok_decode
from repro_torch.data.tokenizer import encode
from repro_torch.models import transformer as tf_mod
from repro_torch.obs import trace as obs_trace

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    prompt: bytes
    max_new_tokens: int = 64
    out_tokens: list = field(default_factory=list)
    done: bool = False

    @property
    def text(self) -> bytes:
        return tok_decode(np.asarray(self.out_tokens, np.int32))


class ServeEngine:
    def __init__(self, cfg: tf_mod.TransformerConfig,
                 params: tf_mod.Transformer, batch_size: int = 4,
                 max_seq: int = 512, temperature: float = 0.0,
                 seed: int = 0,
                 device: "str | torch.device" = "cuda") -> None:
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(f"params lie on {params.device}, the engine "
                             f"runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.temperature = temperature
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.stats = {"requests": 0, "tokens_generated": 0, "batches": 0,
                      "decode_s": 0.0}

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0:
            return logits.argmax(-1)
        probs = torch.softmax(logits.to(torch.float32) / self.temperature,
                              dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def run_batch(self, requests: list[Request]) -> list[Request]:
        B = self.batch_size
        requests = requests[:B]
        prompts = [np.concatenate(([BOS_ID], encode(r.prompt)))
                   for r in requests]
        while len(prompts) < B:  # pad slots replay the first prompt
            prompts.append(prompts[0])
        max_prompt = max(p.size for p in prompts)
        # prompt i + 1 where slot j's prompt goes on, else the sample
        known = np.zeros((B, max_prompt + 1), np.int64)
        has = np.zeros((B, max_prompt + 1), bool)
        for j, p in enumerate(prompts):
            known[j, :p.size] = p
            has[j, :p.size] = True
        known_d = torch.from_numpy(known).to(self.device)
        has_d = torch.from_numpy(has).to(self.device)
        cache = tf_mod.init_cache(self.cfg, B, self.max_seq,
                                  dtype=self.cfg.torch_dtype,
                                  device=self.device)
        traced = obs_trace.enabled()  # one check per batch, not per token
        t0 = time.perf_counter()
        # prefill token-by-token (cache fills positionally)
        tok = known_d[:, 0]
        for i in range(max_prompt):
            logits, cache = tf_mod.decode_step(self.params, cache, tok,
                                               self.cfg)
            sampled = self._sample(logits)
            tok = torch.where(has_d[:, i + 1], known_d[:, i + 1], sampled)
        self._sync()
        t_prefill = time.perf_counter()
        if traced:
            obs_trace.add("serve.prefill", t_prefill - t0)
        # decode
        budget = max(r.max_new_tokens for r in requests)
        for _ in range(min(budget, self.max_seq - max_prompt - 1)):
            host = tok.tolist()
            for j, r in enumerate(requests):
                if not r.done:
                    r.out_tokens.append(host[j])
                    if host[j] == EOS_ID or len(r.out_tokens) >= r.max_new_tokens:
                        r.done = True
            if all(r.done for r in requests):
                break
            logits, cache = tf_mod.decode_step(self.params, cache, tok,
                                               self.cfg)
            tok = self._sample(logits)
        self._sync()
        t_end = time.perf_counter()
        if traced:
            obs_trace.add("serve.decode", t_end - t_prefill)
        dt = t_end - t0
        self.stats["requests"] += len(requests)
        self.stats["tokens_generated"] += sum(
            len(r.out_tokens) for r in requests)
        self.stats["batches"] += 1
        self.stats["decode_s"] += dt
        return requests

    def serve(self, requests: list[Request]) -> list[Request]:
        out = []
        for i in range(0, len(requests), self.batch_size):
            out.extend(self.run_batch(requests[i:i + self.batch_size]))
        return out
