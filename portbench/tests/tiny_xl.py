"""A small size of the SDXL configuration for the CPU tests: the same
topology (three levels, no attention at the first, transformer depths
(1, 2, 3), two towers of different widths, the text_time added
embedding), toy widths, a 16^3 grid and 32^2 frames."""
from __future__ import annotations

TIME_DIM = 8
TINY_SDXL = {
    "image_size": 32,
    "add_time_ids": [32, 32, 0, 0, 32, 32],
    "unet": {
        "sample_size": 16, "block_out_channels": [16, 32, 32], "layers_per_block": 1, "cross_attention_dim": 80,
        "attention_head_dim": [2, 4, 4], "transformer_layers_per_block": [1, 2, 3], "norm_num_groups": 4,
        "addition_time_embed_dim": TIME_DIM, "projection_class_embeddings_input_dim": 40 + 6 * TIME_DIM,
    },
    "vae": {"block_out_channels": [8, 16], "layers_per_block": 1, "norm_num_groups": 4},
    "text_encoder": {"vocab_size": 1024, "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
                     "num_attention_heads": 4},
    "text_encoder_2": {"vocab_size": 1024, "hidden_size": 48, "intermediate_size": 96, "num_hidden_layers": 2,
                       "num_attention_heads": 4, "projection_dim": 40},
}
OVERRIDES = {"edit-sdxl": {"config": {"sd": TINY_SDXL, "grid": {"res": 16}, "edit": {"base_res": 32}}}}
F32 = {"config": {"grid": {"gather_dtype": "float32"}, "sd": {"dtypes": {"unet": "float32", "vae": "float32"}}}}
