"""Qwen3-235B-A22B: 94L d4096 64H(kv4) MoE 128e top-8 d_ff 1536 v151936.

[hf:Qwen/Qwen3-235B-A22B; config family verified via hf:Qwen/Qwen3-30B-A3B]
head_dim 128 per the published config (attention dims decouple from
d_model in Qwen3). Analytic totals: 235.1B params, 22.2B active.
"""
from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, vocab=151936, moe_experts=128, moe_top_k=8,
    rope_theta=1_000_000.0, dtype="bfloat16",
    # §Perf hillclimb: 94-layer carries + Adam state exceed v5e HBM at
    # 256 chips without 8-way grad accumulation + 8-bit optimizer state
    train_microbatches=8, compact_opt_state=True,
    grad_accum_dtype="bfloat16",
)

REDUCED = TransformerConfig(
    name="qwen3-moe-235b-a22b-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=48, vocab=512, moe_experts=8, moe_top_k=2,
    dtype="float32", attn_chunk=64,
)

SPEC = ArchSpec(
    arch_id="qwen3_moe_235b_a22b",
    family="lm",
    config=CONFIG,
    reduced=REDUCED,
    shapes=lm_shapes(),
    notes="flagship MoE; expert-parallel over the model axis (128e/16=8 per "
          "device), most representative of large-scale WARC-corpus training; "
          "its 470.19 GB of bf16 weights do not fit one GPU, so the port "
          "runs only its reduced config (CPU parity tests)",
)
