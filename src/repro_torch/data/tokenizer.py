"""Byte-level tokenizer (trained-vocab-free, suits offline reproduction).

ids: 0 = PAD, 1 = BOS, 2 = EOS, byte b -> b + 3. Vocab = 259, padded to
384 for lane alignment. Models with larger vocabs simply use a prefix of
their embedding table during the end-to-end example runs.
"""
from __future__ import annotations

import numpy as np

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
BYTE_OFFSET = 3
VOCAB_SIZE = 384  # 259 used, padded to a multiple of 128


def encode(text: bytes) -> np.ndarray:
    arr = np.frombuffer(bytes(text), dtype=np.uint8).astype(np.int32)
    return arr + BYTE_OFFSET


def encode_document(text: bytes) -> np.ndarray:
    body = encode(text)
    return np.concatenate(([BOS_ID], body, [EOS_ID])).astype(np.int32)


def decode(ids) -> bytes:
    ids = np.asarray(ids)
    ids = ids[ids >= BYTE_OFFSET] - BYTE_OFFSET
    return ids.astype(np.uint8).tobytes()
