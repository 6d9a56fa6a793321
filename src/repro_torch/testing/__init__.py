"""Test support: deterministic byte corruption of WARC images and
process-fault injection for the pool's and the readahead decoder's
supervision tests (import-light: no CUDA work, no heavy dependencies)."""
from .faults import (
    DamagedSpan,
    arm_decoder_stall,
    arm_worker_kill,
    corrupt_warc,
    member_spans,
)

__all__ = [
    "DamagedSpan",
    "arm_decoder_stall",
    "arm_worker_kill",
    "corrupt_warc",
    "member_spans",
]
