"""Blocked GQA flash attention: the LM's attention kernel (prefill, every
decode step and, with its backward kernel, training)."""
from .backward import flash_attention_backward
from .flash_attention import (HEAD_DIMS, flash_attention_bhsd,
                              flash_attention_fwd_lse)
from .ops import FlashAttentionFn, flash_attention
from .ref import attention_backward_plain, attention_plain

__all__ = ["FlashAttentionFn", "HEAD_DIMS", "attention_backward_plain",
           "attention_plain", "flash_attention", "flash_attention_backward",
           "flash_attention_bhsd", "flash_attention_fwd_lse"]
