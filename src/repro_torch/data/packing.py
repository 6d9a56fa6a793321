"""Sequence packing: document token streams → fixed [B, S] training batches.

GPT-style contiguous packing (documents concatenated, EOS-separated,
crossing sequence boundaries) with an optional segment-ids output for
packers that mask cross-document attention. A copy of the reference's
``repro.data.packing``: host numpy, no device.
"""
from __future__ import annotations

import numpy as np

from .tokenizer import EOS_ID, PAD_ID

__all__ = ["SequencePacker", "pad_batch", "segment_ids"]


class SequencePacker:
    """Stateful packer; feed token arrays, emit full [S+1] rows.

    Rows carry S+1 tokens so the trainer derives (inputs, labels) =
    (row[:-1], row[1:]) without re-reading. The internal remainder buffer
    is part of the checkpointable pipeline state.
    """

    def __init__(self, seq_len: int) -> None:
        self.seq_len = seq_len
        self._buf = np.zeros((0,), np.int32)

    def feed(self, tokens: np.ndarray) -> list[np.ndarray]:
        buf = np.concatenate([self._buf, tokens.astype(np.int32)])
        rows = []
        row = self.seq_len + 1
        while buf.size >= row:
            rows.append(buf[:row].copy())
            # overlap by one token so labels stay contiguous across rows
            buf = buf[self.seq_len:]
        self._buf = buf
        return rows

    def state(self) -> dict:
        return {"buf": self._buf.tolist()}

    def restore(self, state: dict) -> None:
        self._buf = np.asarray(state["buf"], np.int32)


def segment_ids(row: np.ndarray) -> np.ndarray:
    """Document index per position (EOS starts a new segment)."""
    return np.cumsum(np.concatenate(([0], (row[:-1] == EOS_ID))))\
        .astype(np.int32)


def pad_batch(rows: list[np.ndarray], batch: int, seq_len: int) -> np.ndarray:
    """Stack rows into [batch, seq_len+1], padding short batches."""
    out = np.full((batch, seq_len + 1), PAD_ID, np.int32)
    for i, r in enumerate(rows[:batch]):
        out[i, :r.size] = r
    return out
