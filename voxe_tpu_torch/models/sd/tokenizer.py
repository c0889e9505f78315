"""Tokenizers (counterpart of voxe_tpu/models/sd/tokenizer.py; a copy, so
the port needs nothing from the JAX package).

`CLIPTokenizer` is CLIP's byte-level BPE read from a local HF tokenizer
directory (vocab.json + merges.txt, or OpenAI's gzipped merges), with the
BOS/EOS ids taken from the vocab and the pad token from
special_tokens_map.json / tokenizer_config.json (SD 2.x pads with "!",
SD 1.x with EOS). `HashTokenizer` is the stand-in used with seeded random
weights: each word hashes to a stable id in the same [B, 77] layout.
"""
from __future__ import annotations

import gzip
import hashlib
import html
import json
import re
from pathlib import Path
from typing import List

import numpy as np

BOS_TOKEN_ID = 49406
EOS_TOKEN_ID = 49407
MODEL_MAX_LENGTH = 77

# CLIP's pattern with \p{L}/\p{N} spelled for stdlib `re`: [^\W\d_]+ is a
# run of letters, \d one number char, (?:[^\s\w]|_)+ a run of punctuation
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE,
)


def _bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """Byte-level BPE with lowercasing, CLIP special tokens, max length 77."""

    def __init__(self, vocab_path: Path):
        vocab_path = Path(vocab_path)
        with open(vocab_path / "vocab.json") as f:
            self.encoder = json.load(f)
        merges_file = vocab_path / "merges.txt"
        if merges_file.exists():
            merges = merges_file.read_text(encoding="utf-8").split("\n")
        else:  # OpenAI's gzipped merges
            with gzip.open(vocab_path / "bpe_simple_vocab_16e6.txt.gz") as f:
                merges = f.read().decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in merges if m and not m.startswith("#")]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.cache = {}
        # a reduced vocab holds the specials elsewhere than CLIP's 49408 ids
        self.bos_token_id = self.encoder.get("<|startoftext|>", BOS_TOKEN_ID)
        self.eos_token_id = self.encoder.get("<|endoftext|>", EOS_TOKEN_ID)
        pad_token = None
        for fname in ("special_tokens_map.json", "tokenizer_config.json"):
            cfg_file = vocab_path / fname
            if cfg_file.exists():
                declared = json.loads(cfg_file.read_text()).get("pad_token")
                if isinstance(declared, dict):
                    declared = declared.get("content")
                if declared:
                    pad_token = declared
                    break
        self.pad_token_id = (
            self.encoder[pad_token]
            if pad_token is not None and pad_token in self.encoder
            else self.eos_token_id
        )

    def _bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        self.cache[token] = list(word)
        return list(word)

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        bpe_tokens: List[int] = []
        for token in re.findall(_PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self._bpe(token))
        return bpe_tokens

    def __call__(self, texts) -> np.ndarray:
        """texts (str or list) -> [B, 77] int32 ids: BOS ... EOS, truncated,
        padded with the declared pad token."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), MODEL_MAX_LENGTH), self.pad_token_id, dtype=np.int32)
        for row, text in enumerate(texts):
            ids = [self.bos_token_id] + self.encode(text)[: MODEL_MAX_LENGTH - 2] + [self.eos_token_id]
            out[row, : len(ids)] = ids
        return out


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
