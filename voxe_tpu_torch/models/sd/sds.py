"""Stable Diffusion wrapper + Score Distillation Sampling loss
(counterpart of voxe_tpu/models/sd/sds.py; reference
thre3d_atom/thre3d_reprs/sd.py:20-385).

* `SpecifyGradient` is the reference's autograd.Function (the JAX package's
  `specify_gradient` custom VJP): the forward returns a zero "loss", the
  backward injects the precomputed SDS gradient w(t)(eps_hat - eps)/B into
  the latents.
* UNet and VAE run in bf16 by default; latents and the SDS arithmetic stay
  f32. The UNet runs under `torch.no_grad()` (the JAX stop_gradient).
* On the card, the UNet pass without the probs-edit hook replays a CUDA
  graph of itself (`unet_noise_pred`): the pass is over a thousand small
  launches on fixed shapes, and dispatching them one by one takes the host
  several times the card's time.
* Weights come from a local HF snapshot (`weights_dir`, read by
  `weights.load_sd_params`, with the BPE `CLIPTokenizer` from its
  `tokenizer/`), or are seeded random ("random") or zeros ("zeros") with the
  `HashTokenizer`. `load_flax_params` carries a JAX parameter tree across.
* The max-timestep annealing (`update_t_schedule`) is host state; t is
  drawn in [min_step, max_step] from a `torch.Generator`.
* `scoreDistillationLoss` holds the four "<prompt>, {side, overhead, back,
  front} view" encodings (or the bare prompt's).
* `attention_maps` / `get_attn_map` are the refinement stage's attention
  extraction: one noised CFG UNet pass with capture, then per-token maps at
  the render's size (`cross_attn.aggregate_token_maps`).
* Text-to-image sampling: `produce_latents` (the DDIM loop on the host over
  Python-int timesteps, one CFG UNet pass a step), `decode_latents` and
  `prompt_to_img`.
* `train_step` / `scoreDistillationLoss.training_step` are the reference's
  host API over `sds_loss` (schedule update, t draw, the loss).
* SDXL ("xl", the port's own) conditions on a text record, `SDXLText`: the
  two towers' penultimate states side by side (the context), the second
  tower's projected pooled row and the micro-conditioning time ids. An
  empty negative prompt is zeros (the published pipeline's
  `force_zeros_for_empty_prompt`). Everywhere a text embedding goes, SDXL's
  record goes instead; the UNet's CUDA graph takes each of its tensors as a
  static input that every replay fills.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from voxe_tpu_torch.models.sd.clip_text import CLIPTextModel
from voxe_tpu_torch.models.sd.config import SD_VERSIONS, SDConfig, tiny_test_config
from voxe_tpu_torch.models.sd.norms import GroupNorm
from voxe_tpu_torch.models.sd.scheduler import DDIMScheduler
from voxe_tpu_torch.models.sd.tokenizer import CLIPTokenizer, HashTokenizer, get_num_tokens
from voxe_tpu_torch.models.sd.unet import UNet2DConditionModel
from voxe_tpu_torch.models.sd.vae import AutoencoderKL
from voxe_tpu_torch.models.sd.weights import from_flax_params, load_sd_params
from voxe_tpu_torch.utils import tracing
from voxe_tpu_torch.utils.logging import log
from voxe_tpu_torch.utils.timing import FrameClock

DIRECTION_PROMPTS = ("side", "overhead", "back", "front")


class SpecifyGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, latents, gt_grad):
        ctx.save_for_backward(gt_grad)
        ctx.batch_size = latents.shape[0]
        return torch.zeros((), dtype=latents.dtype, device=latents.device)

    @staticmethod
    def backward(ctx, g):
        (gt_grad,) = ctx.saved_tensors
        return g * gt_grad / ctx.batch_size, None


def specify_gradient(latents, gt_grad):
    return SpecifyGradient.apply(latents, gt_grad)


class SDXLText(NamedTuple):
    """SDXL's text conditioning, rows in the CFG order (unconditional,
    conditional) behind any leading dims: the context [..., 77, 2048], the
    pooled rows [..., 1280] and the time ids [..., 6]."""

    context: torch.Tensor
    pooled: torch.Tensor
    time_ids: torch.Tensor


TextEmbeddings = Union[torch.Tensor, SDXLText]


def map_text(fn, text: TextEmbeddings) -> TextEmbeddings:
    """`fn` over a text embedding's tensors: the tensor itself, or each of
    an SDXL record's."""
    return SDXLText(*(fn(x) for x in text)) if isinstance(text, SDXLText) else fn(text)


def text_leaves(text: TextEmbeddings) -> tuple:
    """A text embedding's tensors, in order."""
    return tuple(text) if isinstance(text, SDXLText) else (text,)


def select_text(text: TextEmbeddings, index) -> TextEmbeddings:
    """Row `index` of a stack of text embeddings (the multi-step's
    direction table)."""
    return map_text(lambda x: x[index], text)


def stack_text(texts: Sequence[TextEmbeddings]) -> TextEmbeddings:
    """Text embeddings stacked on a new first dim."""
    if isinstance(texts[0], SDXLText):
        return SDXLText(*(torch.stack(parts) for parts in zip(*texts)))
    return torch.stack(list(texts))


def empty_negative_pairs(cond: SDXLText) -> SDXLText:
    """[N, ...] conditional rows -> [N, 2, ...] (unconditional, conditional)
    pairs whose unconditional context and pooled row are zeros, SDXL's
    empty negative prompt; both rows carry the same time ids."""
    return SDXLText(
        torch.stack([torch.zeros_like(cond.context), cond.context], dim=1),
        torch.stack([torch.zeros_like(cond.pooled), cond.pooled], dim=1),
        torch.stack([cond.time_ids, cond.time_ids], dim=1),
    )


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    """channels_last for a 4-D tensor laid out so (and not also plainly
    contiguous), else contiguous_format."""
    channels_last = x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last)
    return torch.channels_last if channels_last and not x.is_contiguous() else torch.contiguous_format


def unet_replays(latents_in: torch.Tensor, attn_edit_fn) -> bool:
    """Whether a no-grad UNet call runs as a CUDA graph's replay: on the
    card, without the probs-edit hook (a Python callable, which may do host
    work on every call)."""
    return latents_in.device.type == "cuda" and attn_edit_fn is None


def unet_graph_key(latents_in: torch.Tensor, text_embeddings: TextEmbeddings, capture_attn: bool) -> tuple:
    """The signature a captured UNet call is replayed under: all that its
    kernels depend on besides the values of the latents, t and the text
    embeddings. Those are the inputs' shapes and dtypes (each tensor of an
    SDXL text record: context, pooled rows, time ids), the latents' memory
    format, the capture flag and the device, and the float32 matmul
    precision (the time embedding's and the capture path's products are
    float32: a graph keeps the kernels its capture chose)."""
    return (
        tuple(latents_in.shape), latents_in.dtype, _memory_format(latents_in),
        type(text_embeddings).__name__, *((tuple(x.shape), x.dtype) for x in text_leaves(text_embeddings)),
        bool(capture_attn), latents_in.device, torch.get_float32_matmul_precision(),
    )


def _map_outputs(fn, outputs):
    """`fn` over a UNet call's output tensors (the prediction; with capture,
    each (tag, map)'s map), in their structure."""
    if isinstance(outputs, tuple):
        out, store = outputs
        return fn(out), [(tag, fn(m)) for tag, m in store]
    return fn(outputs)


class _UNetGraph:
    """One captured no-grad UNet call: the static inputs it reads (the
    latents, t as a 0-d int64 tensor on the card, the text embeddings, or
    each tensor of an SDXL text record), the outputs it writes, and the
    program counts a replay adds (`tracing.captured`)."""

    def __init__(self, latents_in: torch.Tensor, text_embeddings: TextEmbeddings):
        dev = latents_in.device
        self.latents = torch.empty(
            latents_in.shape, dtype=latents_in.dtype, device=dev, memory_format=_memory_format(latents_in)
        )
        self.t = torch.zeros((), dtype=torch.long, device=dev)
        self.text = map_text(lambda x: torch.empty(x.shape, dtype=x.dtype, device=dev), text_embeddings)
        self.graph = torch.cuda.CUDAGraph()
        self.outputs = None
        self.tally: dict = {}

    def fill(self, latents_in, t, text_embeddings) -> None:
        """The call's inputs into the static ones: copies and a fill, which
        the card runs in order and the host does not wait for."""
        self.latents.copy_(latents_in)
        self.t.fill_(t)
        for static, given in zip(text_leaves(self.text), text_leaves(text_embeddings)):
            static.copy_(given)


@torch.no_grad()
def _random_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init: weights ~ N(0, 1/fan_in), biases 0, norm scales 1."""
    for sub in module.modules():
        if isinstance(sub, (nn.LayerNorm, GroupNorm)):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
        elif isinstance(sub, (nn.Linear, nn.Conv2d, nn.Embedding)):
            w = sub.weight
            fan_in = w.shape[1] if isinstance(sub, nn.Embedding) else w[0].numel()
            noise = torch.randn(w.shape, generator=generator, device=generator.device)
            w.copy_(noise * fan_in**-0.5)
            if getattr(sub, "bias", None) is not None:
                sub.bias.zero_()


class StableDiffusion:
    """Frozen SD pipeline: tokenizer + CLIP text + VAE + UNet + schedule."""

    def __init__(
        self,
        sd_version: str = "2.1",
        config: Optional[SDConfig] = None,
        weights_dir: Optional[Path] = None,
        t_sched_start: int = 1500,
        t_sched_freq: int = 500,
        t_sched_gamma: float = 1.0,
        seed: int = 0,
        unet_dtype=torch.bfloat16,
        vae_dtype=None,
        init_mode: str = "random",
        device="cuda",
    ):
        if config is None:
            config = tiny_test_config() if sd_version == "tiny" else SD_VERSIONS[sd_version]
        self.config = config
        self.t_sched_start = t_sched_start
        self.t_sched_freq = t_sched_freq
        self.t_sched_gamma = t_sched_gamma
        self.num_train_timesteps = config.num_train_timesteps
        self.min_step_ratio = 0.02
        self.max_step_ratio = 0.98
        self.device = torch.device(device)
        self.unet_dtype = unet_dtype
        self.vae_dtype = unet_dtype if vae_dtype is None else vae_dtype
        self.scheduler = DDIMScheduler(
            config.num_train_timesteps, config.beta_start, config.beta_end, device=self.device
        )
        self.alphas = self.scheduler.alphas_cumprod
        self.tokenizer = HashTokenizer(config.clip.vocab_size)
        self.tokenizer_2 = self.tokenizer  # SDXL's second tower's; a snapshot may bring its own

        with self.device:  # build in place: no host copy of 1.3B parameters
            self.clip = CLIPTextModel(config.clip)
            # SDXL's second text tower (OpenCLIP bigG, pooled projection)
            self.clip_2 = CLIPTextModel(config.clip_2) if config.clip_2 is not None else None
            self.vae = AutoencoderKL(config.vae)
            self.unet = UNet2DConditionModel(config.unet)
        if weights_dir is not None:
            params = load_sd_params(Path(weights_dir), config)
            for name, state in params.items():
                getattr(self, name).load_state_dict(state, strict=True)
            self.tokenizer = CLIPTokenizer(Path(weights_dir) / "tokenizer")
            second = Path(weights_dir) / "tokenizer_2"  # SDXL's, which pads otherwise
            self.tokenizer_2 = CLIPTokenizer(second) if second.is_dir() else self.tokenizer
        elif init_mode == "random":
            gen = torch.Generator(device=self.device).manual_seed(seed)
            for m in self.networks():
                _random_init_(m, gen)
        elif init_mode == "zeros":
            for m in self.networks():
                for p in m.parameters():
                    p.data.zero_()
        else:
            raise ValueError(f"init_mode {init_mode!r}: 'random' or 'zeros'")
        self._place()
        self._text_embed_cache: Dict[str, torch.Tensor] = {}
        # the side stream of every capture: cuBLAS keeps a workspace for each stream it runs on
        self._capture_stream: Optional[torch.cuda.Stream] = None

    def networks(self) -> list:
        """The pipeline's networks: the text tower(s), the VAE and the UNet."""
        towers = [self.clip] if self.clip_2 is None else [self.clip, self.clip_2]
        return towers + [self.vae, self.unet]

    def _place(self) -> None:
        memory_format = (
            torch.channels_last if self.device.type == "cuda" else torch.contiguous_format
        )
        self.clip.to(self.device, torch.float32)
        if self.clip_2 is not None:
            self.clip_2.to(self.device, torch.float32)
        self.vae.to(self.device, self.vae_dtype, memory_format=memory_format)
        self.unet.to(self.device, self.unet_dtype, memory_format=memory_format)
        for m in self.networks():
            m.eval().requires_grad_(False)
        # a captured UNet call reads the parameters where they were: drop them all
        self._unet_graphs: Dict[tuple, _UNetGraph] = {}

    def load_flax_params(self, params: Mapping) -> None:
        """Load a JAX parameter tree {"clip", "vae", "unet"} (numpy leaves)."""
        for name in ("clip", "vae", "unet"):
            getattr(self, name).load_state_dict(from_flax_params(params[name]), strict=True)
        self._place()
        self._text_embed_cache.clear()

    # ------------------------------------------------------------------
    # host-side t schedule
    # ------------------------------------------------------------------
    def update_t_schedule(self, global_step: int) -> None:
        """Anneal max_step_ratio by gamma every t_sched_freq steps from
        t_sched_start, floored at 0.22."""
        if global_step >= self.t_sched_start and global_step % self.t_sched_freq == 0:
            self.max_step_ratio = max(self.max_step_ratio * self.t_sched_gamma, 0.22)

    def get_max_step_ratio(self) -> float:
        return self.max_step_ratio

    def t_bounds(self):
        """(min_step, max_step) of the current schedule, inclusive."""
        return (
            int(self.num_train_timesteps * self.min_step_ratio),
            int(self.num_train_timesteps * self.max_step_ratio),
        )

    def sample_timestep(self, generator: torch.Generator) -> int:
        """t ~ U{min_step, ..., max_step} with the current annealed bounds."""
        lo, hi = self.t_bounds()
        t = torch.randint(lo, hi + 1, (), generator=generator, device=generator.device)
        return int(tracing.scalar(t, "draw.t"))

    def get_num_tokens(self, prompt: str) -> int:
        return get_num_tokens(self.tokenizer, prompt)

    @torch.no_grad()
    def get_text_embeds(self, prompt, negative_prompt="") -> TextEmbeddings:
        """[2, 77, D] (uncond, cond), cached per prompt pair; for SDXL an
        `SDXLText` of two rows, zeros for an empty negative prompt."""
        cache_key = f"{prompt}|||{negative_prompt}"
        if cache_key not in self._text_embed_cache:
            if self.clip_2 is not None:
                self._text_embed_cache[cache_key] = self._xl_text_embeds(prompt, negative_prompt)
            else:
                ids = np.concatenate(
                    [self.tokenizer(negative_prompt), self.tokenizer(prompt)], axis=0
                )
                ids_t = torch.as_tensor(ids, dtype=torch.long, device=self.device)
                self._text_embed_cache[cache_key] = self.clip(ids_t)
        return self._text_embed_cache[cache_key]

    def _xl_text_embeds(self, prompt, negative_prompt) -> SDXLText:
        def ids(tokenizer):
            pair = np.concatenate([tokenizer(negative_prompt), tokenizer(prompt)], axis=0)
            return torch.as_tensor(pair, dtype=torch.long, device=self.device)

        text = self.encode_text_xl(ids(self.tokenizer), ids(self.tokenizer_2))
        if negative_prompt == "":
            return select_text(empty_negative_pairs(select_text(text, slice(1, 2))), 0)
        return text

    @torch.no_grad()
    @tracing.traced("sd.text")
    def encode_text_xl(self, ids: torch.Tensor, ids_2: torch.Tensor) -> SDXLText:
        """SDXL's conditioning of B prompts from each tower's [B, 77] ids:
        the two towers' penultimate states side by side [B, 77, D1 + D2],
        the second tower's projected pooled rows [B, P] and the configured
        time ids [B, 6], all f32."""
        context_1, _ = self.clip.penultimate_and_pooled(ids)
        context_2, pooled = self.clip_2.penultimate_and_pooled(ids_2)
        time_ids = tracing.upload(self.config.add_time_ids, "sd.time_ids", dtype=torch.float32, device=self.device)
        return SDXLText(torch.cat([context_1, context_2], dim=-1), pooled, time_ids.expand(ids.shape[0], -1))

    # ------------------------------------------------------------------
    def latent_shape(self, batch: int):
        f = 2 ** (len(self.config.vae.block_out_channels) - 1)
        s = self.config.image_size // f
        return (batch, self.config.vae.latent_channels, s, s)

    @tracing.traced("sd.encode")
    def encode_imgs(self, imgs_nchw, eps=None):
        """imgs [B, 3, H, W] in [0, 1] -> f32 scaled latents [B, 4, h, w],
        run in the VAE's dtype."""
        x = (2.0 * imgs_nchw - 1.0).to(self.vae_dtype)
        if self.device.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        return self.vae.encode(x, eps).float()

    @torch.no_grad()
    def decode_latents(self, latents):
        """Scaled latents [B, 4, h, w] -> images [B, 3, H, W] in [0, 1], f32;
        the VAE runs in its dtype."""
        x = latents.to(self.vae_dtype)
        if self.device.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        return torch.clamp(self.vae.decode(x).float() / 2.0 + 0.5, 0.0, 1.0)

    @torch.no_grad()
    @tracing.traced("sd.unet")
    def unet_noise_pred(self, latents_in, t, text_embeddings, capture_attn: bool = False, attn_edit_fn=None):
        """UNet call on [2B, 4, h, w] (CFG batch) -> f32 noise prediction;
        with `capture_attn`, (prediction, captured (tag, [2B, Q, K]) maps).
        `attn_edit_fn` is the UNet's probs-edit hook.

        On the card without the hook (`unet_replays`) the call runs as a CUDA
        graph, one for each signature (`unet_graph_key`): a signature's
        first call is captured (`_capture_unet`); each later one fills the
        graph's static inputs, replays it and returns copies of its outputs,
        which the next replay does not overwrite. Elsewhere it runs eagerly.
        Either way the same kernels compute the same values."""
        tracing.count("tracing.UNET_CALLS")
        if not unet_replays(latents_in, attn_edit_fn):
            return self._unet_eager(latents_in, t, text_embeddings, capture_attn, attn_edit_fn)
        key = unet_graph_key(latents_in, text_embeddings, capture_attn)
        captured = self._unet_graphs.get(key)
        if captured is None:
            return self._capture_unet(key, latents_in, t, text_embeddings, capture_attn)
        captured.fill(latents_in, t, text_embeddings)
        captured.graph.replay()
        tracing.replayed(captured.tally)
        tracing.count("tracing.UNET_REPLAYS")
        return _map_outputs(torch.clone, captured.outputs)

    def _unet_eager(self, latents_in, t, text_embeddings, capture_attn: bool, attn_edit_fn=None):
        """The UNet call dispatched operator by operator."""
        x = latents_in.to(self.unet_dtype)
        if self.device.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        store = [] if capture_attn else None
        if isinstance(text_embeddings, SDXLText):
            context, added = text_embeddings.context, (text_embeddings.pooled, text_embeddings.time_ids)
        else:
            context, added = text_embeddings, None
        out = self.unet(
            x, t, context.to(self.unet_dtype), attn_store=store, attn_edit_fn=attn_edit_fn, added_cond=added
        ).float()
        return (out, store) if capture_attn else out

    def _capture_unet(self, key: tuple, latents_in, t, text_embeddings, capture_attn: bool):
        """A signature's first call: an eager warm-up pass on a side stream
        from the static inputs, so that cuDNN's, cuBLAS's and the flash
        kernel's one-time set-up happens outside the capture, then the
        capture on that stream into the graph's own memory pool. Returns the
        warm-up's output: the call runs the UNet's kernels once, as every
        call does. t reaches the UNet as a tensor on the card, so no host
        copy is captured."""
        captured = _UNetGraph(latents_in, text_embeddings)
        captured.fill(latents_in, t, text_embeddings)
        main = torch.cuda.current_stream(latents_in.device)
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(latents_in.device)
        side = self._capture_stream
        side.wait_stream(main)
        with torch.cuda.stream(side):
            warm = self._unet_eager(captured.latents, captured.t, captured.text, capture_attn)
        # thread_local: another thread's CUDA call (NCCL's watchdog, a loader's pinned copy) cannot void the capture
        with tracing.captured() as captured.tally, torch.cuda.graph(
                captured.graph, stream=side, capture_error_mode="thread_local"):
            captured.outputs = self._unet_eager(captured.latents, captured.t, captured.text, capture_attn)
        main.wait_stream(side)
        _map_outputs(lambda x: x.record_stream(main), warm)  # made on the side stream, read on the main one
        self._unet_graphs[key] = captured
        return warm

    def _draws(self, given, batch: int, generator, dev):
        """A [B, 4, h, w] draw: `given` ([B, h, w, 4] NHWC) replayed, else
        standard normal from `generator`."""
        if given is not None:
            return given.to(dev, torch.float32).permute(0, 3, 1, 2)
        return torch.randn(self.latent_shape(batch), generator=generator, device=dev)

    def resize_to_image_size(self, imgs_nhwc: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, 3, S, S] at SD's image size, bilinear as
        jax.image.resize does it (antialiased when shrinking)."""
        size = self.config.image_size
        return F.interpolate(
            imgs_nhwc.permute(0, 3, 1, 2), size=(size, size), mode="bilinear", antialias=True, align_corners=False
        )

    @torch.no_grad()
    def attention_maps(
        self,
        text_embeddings: TextEmbeddings,  # [2, 77, D], or SDXL's record
        pred_rgb: torch.Tensor,  # [1, H, W, 3] in [0, 1]
        t,
        token_indices: Sequence[int],
        *,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,  # [1, h, w, 4] NHWC
        vae_eps: Optional[torch.Tensor] = None,  # [1, h, w, 4] NHWC
    ) -> torch.Tensor:
        """One noised CFG UNet pass with attention capture: [B, H, W] maps of
        the tokens at `token_indices`, at pred_rgb's size. `noise` and
        `vae_eps` replay given draws; otherwise they come from `generator`."""
        from voxe_tpu_torch.models.sd.cross_attn import aggregate_token_maps

        orig_h, orig_w = pred_rgb.shape[1:3]
        dev = pred_rgb.device
        eps = self._draws(vae_eps, 1, generator, dev)
        noise = self._draws(noise, 1, generator, dev)
        latents = self.encode_imgs(self.resize_to_image_size(pred_rgb), eps)
        latents_noisy = self.scheduler.add_noise(latents, noise, t)
        _, store = self.unet_noise_pred(
            torch.cat([latents_noisy] * 2, dim=0), t, text_embeddings, capture_attn=True
        )
        return aggregate_token_maps(store, token_indices, orig_h, orig_w)

    def get_attn_map(
        self,
        prompt: str,
        pred_rgb: torch.Tensor,  # [1, H, W, 3] in [0, 1]
        timestamp: int = 0,
        indices_to_fetch=(7,),
        *,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        vae_eps: Optional[torch.Tensor] = None,
    ):
        """Per-token 2D attention maps of `prompt` on the frame at its size,
        and the t used: `timestamp`, or with `timestamp <= 0` one drawn from
        the schedule with `generator`."""
        t = timestamp if timestamp > 0 else self.sample_timestep(generator)
        maps = self.attention_maps(
            self.get_text_embeds(prompt, ""), pred_rgb, t, list(indices_to_fetch),
            generator=generator, noise=noise, vae_eps=vae_eps,
        )
        return list(maps.unbind(0)), int(t)

    def sds_loss(
        self,
        text_embeddings: TextEmbeddings,  # [2, 77, D], or SDXL's record
        pred_rgb: torch.Tensor,  # [B, H, W, 3] in [0, 1], differentiable
        t,  # int or 0-d integer tensor
        guidance_scale: float = 100.0,
        *,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,  # [B, h, w, 4] NHWC
        vae_eps: Optional[torch.Tensor] = None,  # [B, h, w, 4] NHWC
    ) -> torch.Tensor:
        """The SDS "loss" whose gradient w.r.t. pred_rgb is the score
        distillation gradient. `noise` and `vae_eps` replay given draws;
        otherwise they are drawn from `generator`."""
        batch = pred_rgb.shape[0]
        dev = pred_rgb.device
        eps = self._draws(vae_eps, batch, generator, dev)
        noise = self._draws(noise, batch, generator, dev)
        latents = self.encode_imgs(self.resize_to_image_size(pred_rgb), eps)

        latents_ng = latents.detach()
        latents_noisy = self.scheduler.add_noise(latents_ng, noise, t)
        latent_model_input = torch.cat([latents_noisy] * 2, dim=0)
        text_ctx = (
            map_text(lambda x: x.repeat_interleave(batch, dim=0), text_embeddings) if batch > 1 else text_embeddings
        )
        noise_pred = self.unet_noise_pred(latent_model_input, t, text_ctx)
        noise_pred_uncond, noise_pred_text = noise_pred.chunk(2, dim=0)
        noise_pred = noise_pred_text + guidance_scale * (noise_pred_text - noise_pred_uncond)

        w = 1.0 - self.alphas[t]
        grad = torch.nan_to_num(w * (noise_pred - noise))
        return specify_gradient(latents, grad)

    def train_step(
        self,
        text_embeddings: TextEmbeddings,
        pred_rgb: torch.Tensor,
        guidance_scale: float = 100.0,
        global_step: int = -1,
        *,
        generator: Optional[torch.Generator] = None,
        t: Optional[int] = None,
        noise: Optional[torch.Tensor] = None,
        vae_eps: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The reference's host API (sd.py:174-234): update the t schedule,
        draw t (or take the given one), return the SDS loss."""
        self.update_t_schedule(global_step)
        if t is None:
            t = self.sample_timestep(generator)
        return self.sds_loss(
            text_embeddings, pred_rgb, t, guidance_scale, generator=generator, noise=noise, vae_eps=vae_eps
        )

    # ------------------------------------------------------------------
    # text-to-image sampling (reference sd.py:236-303)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def produce_latents(
        self,
        text_embeddings: TextEmbeddings,  # [2B, 77, D] (uncond, cond), or SDXL's record
        generator: Optional[torch.Generator] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        latents: Optional[torch.Tensor] = None,  # [B, h, w, 4] NHWC
    ) -> torch.Tensor:
        """DDIM sampling with classifier-free guidance: f32 latents
        [B, 4, h, w] after `num_inference_steps` CFG UNet passes. The start
        is `latents` replayed, else a standard normal draw from `generator`.
        Each step's ms is logged (`ddim_step_ms`, CUDA events on a card)."""
        height = height or self.config.image_size
        width = width or self.config.image_size
        factor = 2 ** (len(self.config.vae.block_out_channels) - 1)
        context = text_leaves(text_embeddings)[0]
        dev = context.device
        if latents is not None:
            latents = latents.to(dev, torch.float32).permute(0, 3, 1, 2)
        else:
            shape = (context.shape[0] // 2, self.config.unet.in_channels, height // factor, width // factor)
            latents = torch.randn(shape, generator=generator, device=dev)
        ts = self.scheduler.timesteps(num_inference_steps).tolist()
        clock = FrameClock(dev)
        for i, t in enumerate(ts):
            t_prev = ts[i + 1] if i + 1 < len(ts) else -1
            noise_pred = self.unet_noise_pred(torch.cat([latents] * 2, dim=0), t, text_embeddings)
            uncond, text = noise_pred.chunk(2, dim=0)
            noise_pred = text + guidance_scale * (text - uncond)
            latents = self.scheduler.step(noise_pred, t, t_prev, latents)
            clock.tick()
        step_ms = clock.ms()
        log.info(f"DDIM sampling: {len(ts)} steps, median {float(np.median(step_ms)):.2f} ms a step",
                 extra={"ddim_step_ms": step_ms})
        return latents

    def prompt_to_img(
        self,
        prompts,
        negative_prompts="",
        generator: Optional[torch.Generator] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        latents: Optional[torch.Tensor] = None,  # [B, h, w, 4] NHWC
    ) -> np.ndarray:
        """Text to uint8 images [B, H, W, 3]. Without `generator` or `latents`
        the start is drawn from a generator seeded with 0; the JAX package
        draws from PRNGKey(0), so the two packages start from different
        latents unless the caller replays them."""
        if generator is None and latents is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        text_embeds = self.get_text_embeds(prompts, negative_prompts)
        latents = self.produce_latents(
            text_embeds, generator, height, width, num_inference_steps, guidance_scale, latents
        )
        imgs = self.decode_latents(latents).permute(0, 2, 3, 1).cpu().numpy()
        return (imgs * 255).round().astype("uint8")


class scoreDistillationLoss:
    """Directional SDS text conditioning (reference sd.py:333-385): the four
    "<prompt>, {side,overhead,back,front} view" embeddings, or the bare
    prompt's when not directional."""

    def __init__(
        self,
        prompt: str,
        sd_model: Optional[StableDiffusion] = None,
        t_sched_start: int = 1500,
        t_sched_freq: int = 500,
        t_sched_gamma: float = 1.0,
        directional: bool = True,
        sd_version: str = "2.0",
        weights_dir: Optional[Path] = None,
        config: Optional[SDConfig] = None,
        device="cuda",
    ):
        self.directional = directional
        self.sd_model = sd_model or StableDiffusion(
            sd_version, config=config, weights_dir=weights_dir, t_sched_start=t_sched_start,
            t_sched_freq=t_sched_freq, t_sched_gamma=t_sched_gamma, device=device,
        )
        if directional:
            self.text_encodings = {}
            for dir_prompt in DIRECTION_PROMPTS:
                log.info(f"encoding text for '{dir_prompt}' direction")
                self.text_encodings[dir_prompt] = self.sd_model.get_text_embeds(prompt + f", {dir_prompt} view", "")
        else:
            self.text_encoding = self.sd_model.get_text_embeds(prompt, "")

    def get_current_max_step_ratio(self) -> float:
        return self.sd_model.get_max_step_ratio()

    def encoding_for_direction(self, direction: Optional[str]) -> torch.Tensor:
        if self.directional:
            if direction is None:
                raise ValueError("must supply direction in directional SDS mode")
            return self.text_encodings[direction]
        return self.text_encoding

    def stacked_encodings(self) -> TextEmbeddings:
        """[4, 2, 77, D] in DIRECTION_PROMPTS order (the multi-step's table;
        for SDXL a record of such stacks)."""
        return stack_text([self.text_encodings[d] for d in DIRECTION_PROMPTS])

    def training_step(
        self,
        output: torch.Tensor,  # [H*W, 3] or [B, H, W, 3] rendered colours
        image_height: int,
        image_width: int,
        directions=None,
        generator: Optional[torch.Generator] = None,
        global_step: int = -1,
        guidance_scale: float = 100.0,
        *,
        draws: Optional[Sequence[Mapping]] = None,
    ) -> torch.Tensor:
        """The reference's host API (sd.py:365-385): the summed SDS loss over
        `directions` (one loss when not directional). `draws`, one mapping a
        loss with any of "t", "noise" and "vae_eps", replays given draws;
        the rest come from `generator`."""
        out_imgs = output.reshape(-1, image_height, image_width, 3)
        if not self.directional:
            encodings = [self.text_encoding]
        else:
            encodings = [self.text_encodings[d] for d in directions]
        draws = draws if draws is not None else [{}] * len(encodings)
        loss = torch.zeros((), device=output.device)
        for text, given in zip(encodings, draws):
            loss = loss + self.sd_model.train_step(
                text, out_imgs, guidance_scale, global_step, generator=generator, **given
            )
        return loss
