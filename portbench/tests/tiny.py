"""Small sizes of the benchmark's configurations for the CPU tests: the
same topology, toy widths, a 16^3 grid and 32^2 frames."""
from __future__ import annotations

TINY_SD = {
    "image_size": 64,
    "unet": {
        "sample_size": 8, "block_out_channels": [16, 32], "layers_per_block": 1, "cross_attention_dim": 32,
        "attention_head_dim": [4, 8], "norm_num_groups": 4,
        "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"], "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"],
    },
    "vae": {"block_out_channels": [8, 16], "layers_per_block": 1, "norm_num_groups": 4},
    "text_encoder": {"vocab_size": 1024, "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
                     "num_attention_heads": 4},
}
TINY_GRID = {"res": 16}

OVERRIDES = {
    "edit-sd2": {"config": {"sd": TINY_SD, "grid": TINY_GRID, "edit": {"base_res": 32}}},
    "refine-sd14": {"config": {"sd": TINY_SD, "grid": TINY_GRID, "refine": {"base_res": 32}}},
    "recon-160": {"config": {"grid": TINY_GRID, "recon": {"base_res": 32},
                             "views": {"num_train_views": 4, "image_size": 32, "focal": 32.0}}},
}
