"""Qwen2.5-32B: 64L d5120 40H(kv8) d_ff 27648 v152064, GQA + QKV bias.

[hf:Qwen/Qwen2.5-32B; config family verified via hf:Qwen/Qwen2.5-0.5B]
d_head = 5120/40 = 128.
"""
from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen2.5-32b",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=27648, vocab=152064, qkv_bias=True,
    rope_theta=1_000_000.0, dtype="bfloat16",
    # §Perf: 64-layer carries put train_4k at 17.9 GiB/chip on v5e-256
    train_microbatches=4, compact_opt_state=True,
)

REDUCED = TransformerConfig(
    name="qwen2.5-32b-reduced",
    n_layers=2, d_model=80, n_heads=5, n_kv_heads=1, d_head=16,
    d_ff=192, vocab=512, qkv_bias=True, dtype="float32", attn_chunk=64,
)

SPEC = ArchSpec(
    arch_id="qwen25_32b",
    family="lm",
    config=CONFIG,
    reduced=REDUCED,
    shapes=lm_shapes(),
    notes="largest dense LM in the pool; d_ff 27648 = 16·1728 shards "
          "evenly, 40 heads pad under the 16-way model axis",
)
