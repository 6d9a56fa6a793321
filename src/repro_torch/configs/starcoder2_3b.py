"""StarCoder2-3B: 30L d3072 24H(kv2) d_ff 12288 v49152, GQA+RoPE.

[arXiv:2402.19173; hf:bigcode/starcoder2-3b] d_head = 3072/24 = 128.
StarCoder2 uses a plain (non-gated) MLP; we keep the framework-wide SwiGLU
block — parameter count differs by the gate matrix; noted as a
substitution in DESIGN.md (uniform FFN keeps the sharding rules shared).
"""
from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="starcoder2-3b",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_head=128,
    d_ff=12288, vocab=49152, rope_theta=999_999.0, dtype="bfloat16",
)

REDUCED = TransformerConfig(
    name="starcoder2-3b-reduced",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_head=16,
    d_ff=256, vocab=512, dtype="float32", attn_chunk=64,
)

SPEC = ArchSpec(
    arch_id="starcoder2_3b",
    family="lm",
    config=CONFIG,
    reduced=REDUCED,
    shapes=lm_shapes(),
    notes="dense code LM; 24 heads is non-divisible by the 16-way model "
          "axis — GSPMD pads (see dry-run notes)",
)
