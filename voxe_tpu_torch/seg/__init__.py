"""Graph-cut segmentation of the attention grids and connected-component
post-processing (host code over a native C++ backend)."""
