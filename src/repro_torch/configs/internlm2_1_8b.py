"""InternLM2-1.8B: 24L d2048 16H(kv8) d_ff 8192 v92544, GQA.

[arXiv:2403.17297; hf:internlm/internlm2-1_8b] d_head = 2048/16 = 128.
"""
from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="internlm2-1.8b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=92544, rope_theta=1_000_000.0, dtype="bfloat16",
)

REDUCED = TransformerConfig(
    name="internlm2-1.8b-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=256, vocab=512, dtype="float32", attn_chunk=64,
)

SPEC = ArchSpec(
    arch_id="internlm2_1_8b",
    family="lm",
    config=CONFIG,
    reduced=REDUCED,
    shapes=lm_shapes(),
    notes="smallest LM of the pool; ~100M-class reduced variant is the "
          "end-to-end training example's base",
)
