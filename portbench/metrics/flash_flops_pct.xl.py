"""The flash kernel's share of the UNet's self-attention FLOPs in the
profiled steps, from the program's counters by route (`ATTN_FLASH_FLOPS`
over the flash, SDPA and probs routes' sum): the rest ran through the
library's SDPA (the 32^2 level's 60 calls a pass) or the f32 probs path."""
from portbench.metrics.lib.attn_flops import flash_pct as read  # noqa: F401

COUNTERS = {
    "attn_flash_flops": ("portbench.metrics.lib.attn_flops", "ATTN_FLASH_FLOPS", "delta"),
    "attn_sdpa_flops": ("portbench.metrics.lib.attn_flops", "ATTN_SDPA_FLOPS", "delta"),
    "attn_probs_flops": ("portbench.metrics.lib.attn_flops", "ATTN_PROBS_FLOPS", "delta"),
}
