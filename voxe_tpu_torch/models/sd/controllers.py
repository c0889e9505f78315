"""Prompt-to-prompt attention controllers on torch tensors (counterpart of
voxe_tpu/models/sd/controllers.py; reference
thre3d_atom/thre3d_reprs/cross_attn.py:204-422).

`controller(attn, place)` returns the edited maps: AttentionStore keeps
them, AttentionReplace / AttentionRefine / AttentionReweight swap the
target prompts' attention toward the source's (row 0 of the batch).
`LocalBlend` blends edited latents into the source's inside a word's
attention mask. The UNet's hook passes `(probs, place, is_cross)`; as in the
JAX package a controller takes `(attn, place)`, so plugging one into the
UNet takes a wrapper: `lambda p, place, is_cross: controller(p, place)`.
Tables (mappers, alphas, equalizers) are built on the host and moved to the
maps' device when applied.
"""
from __future__ import annotations

import abc
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from voxe_tpu_torch.models.sd.cross_attn import upsample_maps
from voxe_tpu_torch.models.sd.seq_aligner import (
    get_refinement_mapper,
    get_replacement_mapper,
    get_word_inds,
)


class AttentionControl(abc.ABC):
    def __init__(self):
        self.cur_step = 0

    def step(self):
        self.cur_step += 1

    @abc.abstractmethod
    def __call__(self, attn: torch.Tensor, place: str) -> torch.Tensor: ...


class AttentionStore(AttentionControl):
    """Accumulates maps with at most 32^2 queries per place
    ("{down,mid,up}_{cross,self}"), summed over steps."""

    MAX_RESOLUTION_SQ = 32**2

    def __init__(self):
        super().__init__()
        self.step_store: Dict[str, List[torch.Tensor]] = self._empty()
        self.attention_store: Dict[str, List[torch.Tensor]] = {}

    @staticmethod
    def _empty():
        return {f"{p}_{t}": [] for p in ("down", "mid", "up") for t in ("cross", "self")}

    def __call__(self, attn: torch.Tensor, place: str) -> torch.Tensor:
        if attn.shape[-2] <= self.MAX_RESOLUTION_SQ:
            self.step_store[place].append(attn)
        return attn

    def between_steps(self):
        if not self.attention_store:
            self.attention_store = self.step_store
        else:
            for key, maps in self.attention_store.items():
                for i in range(len(maps)):
                    maps[i] = maps[i] + self.step_store[key][i]
        self.step_store = self._empty()
        self.step()

    def get_average_attention(self):
        steps = max(self.cur_step, 1)
        return {key: [item / steps for item in maps] for key, maps in self.attention_store.items()}


class AttentionControlEdit(AttentionControl, abc.ABC):
    """Base of the edits: for the first `cross_replace_steps` (a fraction of
    `num_steps`) the targets' cross-attention is replaced, for the first
    `self_replace_steps` their self-attention becomes the source's."""

    def __init__(self, num_steps: int, cross_replace_steps: float = 1.0, self_replace_steps: float = 1.0):
        super().__init__()
        self.num_steps = num_steps
        self.cross_replace_range = int(num_steps * cross_replace_steps)
        self.self_replace_range = int(num_steps * self_replace_steps)

    @abc.abstractmethod
    def replace_cross_attention(self, attn_base, attn_replace): ...

    def __call__(self, attn: torch.Tensor, place: str) -> torch.Tensor:
        """attn [1 + n_targets, heads, Q, K]; row 0 is the source."""
        is_cross = attn.shape[-1] == 77
        attn_base, attn_target = attn[:1], attn[1:]
        if is_cross and self.cur_step < self.cross_replace_range:
            attn_target = self.replace_cross_attention(attn_base, attn_target)
        elif not is_cross and self.cur_step < self.self_replace_range:
            attn_target = attn_base.expand(attn_target.shape)
        return torch.cat([attn_base, attn_target], dim=0)


class AttentionReplace(AttentionControlEdit):
    """Word-for-word replacement through the token permutation mapper."""

    def __init__(self, prompts, tokenizer, num_steps, **kwargs):
        super().__init__(num_steps, **kwargs)
        self.mapper = torch.from_numpy(get_replacement_mapper(prompts, tokenizer))  # [T, 77, 77]

    def replace_cross_attention(self, attn_base, attn_replace):
        mapper = self.mapper.to(attn_base.device, attn_base.dtype)
        # numpy's `repeat` along an axis repeats elements: repeat_interleave
        return torch.einsum("bhqk,bkl->bhql", attn_base.repeat_interleave(len(mapper), dim=0), mapper)


class AttentionRefine(AttentionControlEdit):
    """Prompt refinement through the alignment mapper and its alphas."""

    def __init__(self, prompts, tokenizer, num_steps, **kwargs):
        super().__init__(num_steps, **kwargs)
        mapper, alphas = get_refinement_mapper(prompts, tokenizer)
        self.mapper = torch.from_numpy(mapper)  # [T, 77] int64
        self.alphas = torch.from_numpy(alphas)[:, None, None, :]  # [T, 1, 1, 77]

    def replace_cross_attention(self, attn_base, attn_replace):
        # per target, the source's attention at the mapped token positions
        # (a gather on the last axis), blended by the alignment alphas
        mapper = self.mapper.to(attn_base.device)
        alphas = self.alphas.to(attn_base.device, attn_base.dtype)
        gathered = torch.stack([attn_base[0].index_select(-1, m) for m in mapper])  # [T, h, Q, K]
        return gathered * alphas + attn_replace * (1 - alphas)


class AttentionReweight(AttentionControlEdit):
    """Scales the attention of selected tokens by `equalizer` [T, 77]."""

    def __init__(
        self,
        prompts,
        tokenizer,
        num_steps,
        equalizer: torch.Tensor,
        prev_controller: Optional[AttentionControlEdit] = None,
        **kwargs,
    ):
        super().__init__(num_steps, **kwargs)
        self.equalizer = equalizer[:, None, None, :]
        self.prev_controller = prev_controller

    def replace_cross_attention(self, attn_base, attn_replace):
        if self.prev_controller is not None:
            attn_replace = self.prev_controller.replace_cross_attention(attn_base, attn_replace)
        return attn_replace * self.equalizer.to(attn_replace.device, attn_replace.dtype)


def get_equalizer(text: str, word_select, values: Tuple[float, ...], tokenizer) -> torch.Tensor:
    """[len(values), 77] equalizer for AttentionReweight: `values` at the
    tokens of the selected words, 1 elsewhere."""
    if isinstance(word_select, (int, str)):
        word_select = (word_select,)
    equalizer = np.ones((len(values), 77), dtype=np.float32)
    for word, value in zip(word_select, values):
        equalizer[:, get_word_inds(text, word, tokenizer)] = value
    return torch.from_numpy(equalizer)


class LocalBlend:
    """Blend edited latents into the source's inside the mask of the chosen
    words' attention. Call with latents [B, 4, h, w] (the port's layout) and
    the averaged 16x16 cross-attention maps [B, 16, 16, 77]."""

    def __init__(self, prompts, words, tokenizer, threshold: float = 0.3):
        alpha_layers = np.zeros((len(prompts), 77), dtype=np.float32)
        for i, (prompt, words_) in enumerate(zip(prompts, words)):
            if isinstance(words_, str):
                words_ = [words_]
            for word in words_:
                alpha_layers[i, get_word_inds(prompt, word, tokenizer)] = 1.0
        self.alpha_layers = torch.from_numpy(alpha_layers)[:, None, None, :]
        self.threshold = threshold

    def normalized_map(self, attn_maps_16: torch.Tensor, height: int, width: int) -> torch.Tensor:
        """[B, height, width]: the chosen words' summed attention, enlarged
        to the latents' size and divided by its max (the mask before the
        threshold)."""
        maps = attn_maps_16 * self.alpha_layers.to(attn_maps_16.device, attn_maps_16.dtype)
        mask = upsample_maps(maps.sum(-1), height, width)
        return mask / (mask.amax(dim=(1, 2), keepdim=True) + 1e-8)

    def __call__(self, latents: torch.Tensor, attn_maps_16: torch.Tensor) -> torch.Tensor:
        mask = self.normalized_map(attn_maps_16, *latents.shape[2:]) >= self.threshold
        return latents[:1] + mask.to(latents.dtype)[:, None] * (latents - latents[:1])
