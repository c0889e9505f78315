"""CLIP text encoder (counterpart of voxe_tpu/models/sd/clip_text.py):
pre-LayerNorm transformer with a causal mask. Submodule names follow the
flax module names so `weights.from_flax_params` maps parameters directly.

SDXL reads its towers differently (`penultimate_and_pooled`): the context is
the hidden states after the second-to-last layer, with no final LayerNorm
(transformers' `hidden_states[-2]`), and the second tower's pooled output is
the final LayerNorm's row at the first EOS token times `text_projection`."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from voxe_tpu_torch.models.sd.config import CLIPTextConfig


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    return lambda x: F.gelu(x)  # exact erf GELU, as transformers' "gelu"


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        dim = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, hidden, causal_mask):
        B, T, C = hidden.shape
        d = C // self.heads

        def split(x):
            return x.reshape(B, T, self.heads, d).transpose(1, 2)

        q, k, v = split(self.q_proj(hidden)), split(self.k_proj(hidden)), split(self.v_proj(hidden))
        scores = q @ k.transpose(-1, -2) / math.sqrt(d) + causal_mask
        out = torch.softmax(scores, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(B, T, C))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp_fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.mlp_fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.act = _act(cfg.hidden_act)

    def forward(self, hidden, causal_mask):
        hidden = hidden + self.self_attn(self.layer_norm1(hidden), causal_mask)
        return hidden + self.mlp_fc2(self.act(self.mlp_fc1(self.layer_norm2(hidden))))


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.config = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layers_{i}", CLIPEncoderLayer(cfg))
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        if cfg.projection_dim is not None:
            self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def _layers(self, input_ids: torch.Tensor, hidden=None, start: int = 0, stop: Optional[int] = None):
        """The encoder layers [start, stop) on `hidden` (the token and
        position embeddings of `input_ids` when None)."""
        T = input_ids.shape[-1]
        if hidden is None:
            positions = torch.arange(T, device=input_ids.device)
            hidden = self.token_embedding(input_ids) + self.position_embedding(positions)[None]
        causal_mask = torch.triu(
            torch.full((T, T), float("-inf"), dtype=hidden.dtype, device=hidden.device), 1
        )
        for i in range(start, self.config.num_hidden_layers if stop is None else stop):
            hidden = getattr(self, f"layers_{i}")(hidden, causal_mask)
        return hidden

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids [B, T] -> final-layer hidden states [B, T, D]."""
        return self.final_layer_norm(self._layers(input_ids))

    def penultimate_and_pooled(self, input_ids: torch.Tensor):
        """input_ids [B, T] -> (hidden states after the second-to-last layer,
        unnormalised [B, T, D]; the projected pooled output [B, P], or None
        without `text_projection`, in which case the last layer is not run).
        The pooled row is the first EOS token's: the EOS id is the
        vocabulary's largest, so it is the ids' first argmax, as
        transformers takes it."""
        n = self.config.num_hidden_layers
        penultimate = self._layers(input_ids, stop=n - 1)
        if self.config.projection_dim is None:
            return penultimate, None
        final = self.final_layer_norm(self._layers(input_ids, penultimate, start=n - 1))
        rows = torch.arange(final.shape[0], device=final.device)
        return penultimate, self.text_projection(final[rows, input_ids.argmax(dim=-1)])
