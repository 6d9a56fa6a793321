"""Blocked GQA flash attention: the LM's attention kernel (prefill and
every decode step)."""
from .flash_attention import HEAD_DIMS, flash_attention_bhsd
from .ops import flash_attention
from .ref import attention_plain

__all__ = ["HEAD_DIMS", "attention_plain", "flash_attention",
           "flash_attention_bhsd"]
