"""The paper's own end-to-end config: a ~100M-param byte-level LM trained
on the FastWARC ingestion pipeline's output (Common-Crawl-style corpus).

The reference trains it on the pipeline's output; the port serves it
(``python -m repro_torch.launch.serve``, ``ServeEngine``) with the
flash-attention kernel on the card.
"""
from repro_torch.configs import ArchSpec, ShapeSpec
from repro_torch.data.tokenizer import VOCAB_SIZE
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="fastwarc-lm-100m",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_head=64,
    d_ff=2048, vocab=VOCAB_SIZE, rope_theta=10_000.0, dtype="float32",
    attn_chunk=256,
)

REDUCED = TransformerConfig(
    name="fastwarc-lm-reduced",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab=VOCAB_SIZE, dtype="float32", attn_chunk=64,
)

SPEC = ArchSpec(
    arch_id="fastwarc_lm",
    family="lm",
    config=CONFIG,
    reduced=REDUCED,
    shapes=(
        ShapeSpec("train_1k", "train", {"seq_len": 1024, "global_batch": 32}),
        ShapeSpec("serve_1k", "decode", {"seq_len": 1024, "global_batch": 8}),
    ),
    notes="the paper's deployment context: WARC pipeline → byte-level LM",
)
