"""Prompt sequence alignment for prompt-to-prompt attention editing
(counterpart of voxe_tpu/models/sd/seq_aligner.py; a copy, so the port needs
nothing from the JAX package).

The Needleman-Wunsch global alignment and the token mappers of the
AttentionReplace / AttentionRefine controllers (reference
thre3d_atom/thre3d_reprs/seq_aligner.py:1-196), in numpy. They take the
port's tokenizers (`HashTokenizer`, `CLIPTokenizer`): `encode` gives content
tokens only, `bos_token_id` / `eos_token_id` the specials.

Provenance: `get_matrix` and the traceback-matrix initialization follow
Google's Apache-2.0 prompt-to-prompt reference implementation
(github.com/google/prompt-to-prompt, seq_aligner.py), which the Vox-E
reference vendors verbatim; they are the textbook Needleman-Wunsch
initialization and are retained in that standard form.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np


class ScoreParams(NamedTuple):
    gap: int
    match: int
    mismatch: int

    def mis_match_char(self, x, y):
        return self.match if x == y else self.mismatch


def get_matrix(size_x: int, size_y: int, gap: int) -> np.ndarray:
    matrix = np.zeros((size_x + 1, size_y + 1), dtype=np.int32)
    matrix[0, 1:] = (np.arange(size_y) + 1) * gap
    matrix[1:, 0] = (np.arange(size_x) + 1) * gap
    return matrix


def global_align(x: Sequence[int], y: Sequence[int], score: ScoreParams):
    """Needleman-Wunsch alignment of two token sequences."""
    matrix = get_matrix(len(x), len(y), score.gap)
    trace_back = np.zeros((len(x) + 1, len(y) + 1), dtype=np.int32)
    trace_back[0, 1:] = 1
    trace_back[1:, 0] = 2
    for i in range(1, len(x) + 1):
        for j in range(1, len(y) + 1):
            left = matrix[i, j - 1] + score.gap
            up = matrix[i - 1, j] + score.gap
            diag = matrix[i - 1, j - 1] + score.mis_match_char(x[i - 1], y[j - 1])
            best = max(left, up, diag)
            matrix[i, j] = best
            trace_back[i, j] = 1 if best == left else (2 if best == up else 3)
    return matrix, trace_back


def get_mapper(x: str, y: str, tokenizer, max_len: int = 77):
    """(mapper [77], alphas [77]) for refining prompt x into prompt y.

    mapper is TARGET-indexed: mapper[j] is the source (x) token position whose
    attention the target (y) position j inherits; alphas[j] is 1 where y's
    token aligns to an x token and 0 where it is new material (the refinement
    keeps the target's own attention there). Consumed by
    AttentionRefine.replace_cross_attention as
    `base[..., mapper] * alphas + replace * (1 - alphas)`
    (semantics of reference seq_aligner.py:107-118 / cross_attn.py:302-324,
    with the reference's tail-size bug for different-length prompts fixed).

    Alignment runs in WITH-SPECIALS coordinates (BOS at 0, EOS last), the
    layout of the 77-token attention arrays the mapper indexes into — the
    upstream code gets this for free because HF encode() includes specials,
    while our encode() returns content tokens only.
    """
    bos = getattr(tokenizer, "bos_token_id", 0)
    eos = getattr(tokenizer, "eos_token_id", 0)
    x_seq = [bos] + list(tokenizer.encode(x))[: max_len - 2] + [eos]
    y_seq = [bos] + list(tokenizer.encode(y))[: max_len - 2] + [eos]
    score = ScoreParams(0, 1, -1)
    _, trace_back = global_align(x_seq, y_seq, score)

    # walk the alignment path to build the y-indexed inverse map
    path = []
    i, j = len(x_seq), len(y_seq)
    while i > 0 or j > 0:
        step = trace_back[i, j]
        if step == 3:
            path.append((i - 1, j - 1))
            i -= 1
            j -= 1
        elif step == 1:
            path.append((-1, j - 1))
            j -= 1
        else:
            path.append((i - 1, -1))
            i -= 1

    mapper = np.arange(max_len, dtype=np.int64)  # identity beyond the prompt
    alphas = np.ones(max_len, dtype=np.float32)
    alphas[: len(y_seq)] = 0.0  # default: new material keeps its own attention
    for xi, yi in path:
        if yi >= 0 and xi >= 0:
            mapper[yi] = xi
            alphas[yi] = 1.0
        elif yi >= 0:
            mapper[yi] = 0
    return mapper, alphas


def get_refinement_mapper(prompts: List[str], tokenizer, max_len: int = 77):
    x_seq = prompts[0]
    mappers, alphas = [], []
    for i in range(1, len(prompts)):
        mapper, alpha = get_mapper(x_seq, prompts[i], tokenizer, max_len)
        mappers.append(mapper)
        alphas.append(alpha)
    return np.stack(mappers), np.stack(alphas)


def get_word_inds(text: str, word_place, tokenizer) -> np.ndarray:
    """Token indices covering the word at `word_place`
    (reference seq_aligner.py:131-148). Uses encode() lengths only, so it
    works with both the BPE and hash tokenizers."""
    split_text = text.split(" ")
    if isinstance(word_place, str):
        word_place = [i for i, w in enumerate(split_text) if word_place == w]
    elif isinstance(word_place, int):
        word_place = [word_place]
    out = []
    if word_place:
        ptr = 1  # skip BOS
        for word_idx, word in enumerate(split_text):
            n_tokens = max(len(tokenizer.encode(word)), 1)
            if word_idx in word_place:
                out.extend(range(ptr, ptr + n_tokens))
            ptr += n_tokens
    return np.array(out, dtype=np.int64)


def get_replacement_mapper_(x: str, y: str, tokenizer, max_len: int = 77) -> np.ndarray:
    """[77, 77] soft token-permutation matrix from x's tokens to y's
    (reference seq_aligner.py:152-185)."""
    words_x, words_y = x.split(" "), y.split(" ")
    if len(words_x) != len(words_y):
        raise ValueError(
            "attention replacement edit needs same-length prompts "
            f"({len(words_x)} vs {len(words_y)} words)"
        )
    inds_replace = [i for i in range(len(words_y)) if words_y[i] != words_x[i]]
    inds_source = [get_word_inds(x, i, tokenizer) for i in inds_replace]
    inds_target = [get_word_inds(y, i, tokenizer) for i in inds_replace]
    mapper = np.zeros((max_len, max_len), dtype=np.float32)
    i = j = cur = 0
    while i < max_len and j < max_len:
        if cur < len(inds_source) and len(inds_source[cur]) and inds_source[cur][0] == i:
            src, tgt = inds_source[cur], inds_target[cur]
            if len(src) == len(tgt):
                mapper[src, tgt] = 1.0
            else:
                ratio = 1.0 / len(tgt)
                for t in tgt:
                    mapper[src, t] = ratio
            cur += 1
            i += len(src)
            j += len(tgt)
        elif cur < len(inds_source):
            mapper[i, j] = 1.0
            i += 1
            j += 1
        else:
            mapper[j, j] = 1.0
            i += 1
            j += 1
    return mapper


def get_replacement_mapper(prompts: List[str], tokenizer, max_len: int = 77):
    x_seq = prompts[0]
    return np.stack(
        [get_replacement_mapper_(x_seq, p, tokenizer, max_len) for p in prompts[1:]]
    )
