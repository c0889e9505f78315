"""Deterministic stand-in tokenizer (counterpart of `HashTokenizer` and
`get_num_tokens` in voxe_tpu/models/sd/tokenizer.py; a copy, so the port
needs nothing from the JAX package). The BPE `CLIPTokenizer` for real vocab
files is not ported yet: this slice runs with seeded random weights."""
from __future__ import annotations

import hashlib
import re
from typing import List

import numpy as np

BOS_TOKEN_ID = 49406
EOS_TOKEN_ID = 49407
MODEL_MAX_LENGTH = 77


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class HashTokenizer:
    """Each word hashes to a stable id; [B, 77] BOS ... EOS layout, padded
    with EOS."""

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        ids = []
        for word in _whitespace_clean(text).lower().split(" "):
            if not word:
                continue
            digest = hashlib.sha256(word.encode()).digest()
            ids.append(int.from_bytes(digest[:4], "little") % (self.vocab_size - 3) + 1)
        return ids

    @property
    def bos_token_id(self) -> int:
        return min(BOS_TOKEN_ID, self.vocab_size - 2)

    @property
    def eos_token_id(self) -> int:
        return min(EOS_TOKEN_ID, self.vocab_size - 1)

    def __call__(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        bos, eos = self.bos_token_id, self.eos_token_id
        out = np.full((len(texts), MODEL_MAX_LENGTH), eos, dtype=np.int32)
        for row, text in enumerate(texts):
            ids = [bos] + self.encode(text)[: MODEL_MAX_LENGTH - 2] + [eos]
            out[row, : len(ids)] = ids
        return out


def get_num_tokens(tokenizer, prompt: str) -> int:
    """Count of non-EOS ids in the encoded prompt (BOS included)."""
    ids = tokenizer(prompt)[0]
    eos = getattr(tokenizer, "eos_token_id", EOS_TOKEN_ID)
    return int((ids != eos).sum())
