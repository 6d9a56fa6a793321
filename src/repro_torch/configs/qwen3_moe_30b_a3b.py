"""Qwen3-30B-A3B: 48L d2048 32H(kv4) MoE 128e top-8 d_ff 768 v151936.

[hf:Qwen/Qwen3-30B-A3B; hf] head_dim 128 per the published config.
"""
from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=768, vocab=151936, moe_experts=128, moe_top_k=8,
    rope_theta=1_000_000.0, dtype="bfloat16",
)

REDUCED = TransformerConfig(
    name="qwen3-moe-30b-a3b-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=32, vocab=512, moe_experts=8, moe_top_k=2,
    dtype="float32", attn_chunk=64,
)

SPEC = ArchSpec(
    arch_id="qwen3_moe_30b_a3b",
    family="lm",
    config=CONFIG,
    reduced=REDUCED,
    shapes=lm_shapes(),
    notes="mid-scale MoE sibling of the 235B config; its 61.06 GB of bf16 "
          "weights fit one 80 GB GPU, where the port serves it at full "
          "width",
)
