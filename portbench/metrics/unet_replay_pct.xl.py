"""The share of the profiled steps' SDXL UNet passes that replayed a CUDA
graph of the pass (the program's `UNET_REPLAYS` over `UNET_CALLS`); the
rest had the host dispatch each of the pass's launches."""
from portbench.metrics.lib.unet_graph import replay_pct as read  # noqa: F401

COUNTERS = {
    "unet_calls": ("portbench.metrics.lib.unet_graph", "UNET_CALLS", "delta"),
    "unet_replays": ("portbench.metrics.lib.unet_graph", "UNET_REPLAYS", "delta"),
}
