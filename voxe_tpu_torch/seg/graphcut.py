"""Graph-cut voxel segmentation of the edit region against the object
(counterpart of voxe_tpu/seg/graphcut.py; host numpy, a copy).

The graph is built with vectorised numpy: the non-empty voxels (after a
3x3x3 dilation) are the nodes, seeded to the edit terminal where the edit
grid's attention wins by a margin and to the object terminal from a random
draw of the object-side voxels; 6-neighbour edges carry a colour affinity.
The min cut runs in the native C++ backend (`seg/native.py`).
`get_edit_region` writes the resulting keep grid, -10 empty / -5 object /
0 edit, into the output model's attention field.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from voxe_tpu_torch.seg.native import maxflow_mincut
from voxe_tpu_torch.utils.logging import log

NEIGHBOR_OFFSETS = np.array(
    [
        [1, 0, 0], [-1, 0, 0],
        [0, 1, 0], [0, -1, 0],
        [0, 0, 1], [0, 0, -1],
    ],
    dtype=np.int64,
)

INF_CAP = np.float32(1e30)


def _maxpool3(volume: np.ndarray) -> np.ndarray:
    """3x3x3 stride-1 max-pool with same padding (dilation; reference
    refinement_functions.py:186,200)."""
    padded = np.pad(volume, 1, mode="constant", constant_values=-np.inf)
    out = volume.copy()
    for ox in range(3):
        for oy in range(3):
            for oz in range(3):
                out = np.maximum(
                    out,
                    padded[
                        ox : ox + volume.shape[0],
                        oy : oy + volume.shape[1],
                        oz : oz + volume.shape[2],
                    ],
                )
    return out


def _block_reduce(volume: np.ndarray, factor: int, mode: str) -> np.ndarray:
    """Non-overlapping max/avg pooling over [X, Y, Z, C] (reference :190-196)."""
    X, Y, Z, C = volume.shape
    trimmed = volume[: X // factor * factor, : Y // factor * factor, : Z // factor * factor]
    blocks = trimmed.reshape(
        X // factor, factor, Y // factor, factor, Z // factor, factor, C
    )
    if mode == "max":
        return blocks.max(axis=(1, 3, 5))
    return blocks.mean(axis=(1, 3, 5))


def build_graph(
    features: np.ndarray,  # [X, Y, Z, F] (already sigmoided by caller)
    densities: np.ndarray,  # [X, Y, Z, 1]
    edit_attn: np.ndarray,  # [X, Y, Z, 1]
    obj_attn: np.ndarray,  # [X, Y, Z, 1]
    K: float = 0.05,
    sigma: float = 0.1,
    edit_mask_thresh: float = 0.992,
    num_obj_voxels_thresh: int = 5000,
    min_num_edit_voxels: int = 300,
    top_k_edit_thresh: int = 300,
    top_k_obj_thresh: int = 200,
    downsample_grid: bool = False,
    downsample_factor: int = 4,
    rng: np.random.Generator | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Min-cut the non-empty voxels into edit(0)/object(1) segments.

    Returns (segments [N], voxel indices [N, 3]) like the reference
    (refinement_functions.py:182-298).
    """
    rng = rng or np.random.default_rng(42)

    if downsample_grid:
        density_grid = _block_reduce(densities, downsample_factor, "max")
        feature_grid = _block_reduce(features, downsample_factor, "avg")
        non_zero = density_grid[..., 0] > 0.0
        edit_vals = _block_reduce(edit_attn, downsample_factor, "max")[..., 0][non_zero]
        obj_vals = _block_reduce(obj_attn, downsample_factor, "max")[..., 0][non_zero]
    else:
        density_grid = densities
        feature_grid = features
        # 3x3x3 dilation of the occupancy so the cut can see one-voxel margins
        non_zero = _maxpool3(density_grid[..., 0]) > 0.0
        edit_vals = edit_attn[..., 0][non_zero]
        obj_vals = obj_attn[..., 0][non_zero]

    X, Y, Z = density_grid.shape[:3]
    idx_values = np.argwhere(non_zero)  # [N, 3]
    num_nodes = len(idx_values)
    log.info(f"graph-cut over {num_nodes} non-empty voxels ({X}x{Y}x{Z} grid)")

    # dense voxel -> node-id lookup
    node_id = -np.ones((X, Y, Z), dtype=np.int64)
    node_id[idx_values[:, 0], idx_values[:, 1], idx_values[:, 2]] = np.arange(num_nodes)

    # seed probabilities: softmax over (edit, obj) attn logits (reference :226-239)
    pair = np.stack([edit_vals, obj_vals], axis=-1).astype(np.float64)
    pair = pair - pair.max(axis=-1, keepdims=True)
    exp = np.exp(pair)
    probs = exp / exp.sum(axis=-1, keepdims=True)

    top_prob_edit = probs[:, 0].max() if num_nodes else 0.0
    edit_mask = probs[:, 0] >= edit_mask_thresh * top_prob_edit
    edit_seed_idx = np.nonzero(edit_mask)[0]

    obj_candidates = np.nonzero(probs[:, 1] > probs[:, 0])[0]
    perm = rng.permutation(len(obj_candidates))
    obj_seed_idx = obj_candidates[perm[:num_obj_voxels_thresh]]

    if edit_mask.sum() < min_num_edit_voxels:
        log.info("not enough edit voxels, falling back to top-k by raw attn")
        edit_seed_idx = np.argsort(edit_vals)[::-1][:top_k_edit_thresh]
        obj_seed_idx = np.argsort(obj_vals)[::-1][:top_k_obj_thresh]

    # edit seeds WIN on overlap (reference :252-255 is if/ELIF: a node in
    # both top-k lists gets only the edit terminal). Without this, the two
    # INF capacities cancel in set_terminal and the contested voxel is
    # seeded to neither side.
    obj_seed_idx = np.setdiff1d(obj_seed_idx, edit_seed_idx)
    cap_src = np.zeros(num_nodes, dtype=np.float32)
    cap_snk = np.zeros(num_nodes, dtype=np.float32)
    cap_src[edit_seed_idx] = INF_CAP  # edit terminal (reference :253)
    cap_snk[obj_seed_idx] = INF_CAP  # object terminal (reference :255)

    # vectorized 6-neighbor edges: for each offset, pair nodes whose neighbor
    # is in-bounds, has positive density, and is itself a node. Each
    # undirected pair is emitted TWICE (once per opposing offset) with
    # symmetric capacities — deliberately matching the reference's per-node
    # 6-offset loop (:261-287), so the arc multiset and flow value agree;
    # the min cut itself would be identical with positive offsets only.
    feat_at = feature_grid[idx_values[:, 0], idx_values[:, 1], idx_values[:, 2]]
    dens = density_grid[..., 0]
    edge_u_list, edge_v_list, weight_list = [], [], []
    for offset in NEIGHBOR_OFFSETS:
        nbr = idx_values + offset[None, :]
        in_bounds = (
            (nbr[:, 0] >= 0) & (nbr[:, 0] < X)
            & (nbr[:, 1] >= 0) & (nbr[:, 1] < Y)
            & (nbr[:, 2] >= 0) & (nbr[:, 2] < Z)
        )
        nbr_clipped = np.clip(nbr, 0, [X - 1, Y - 1, Z - 1])
        has_density = dens[nbr_clipped[:, 0], nbr_clipped[:, 1], nbr_clipped[:, 2]] > 0.0
        nbr_id = node_id[nbr_clipped[:, 0], nbr_clipped[:, 1], nbr_clipped[:, 2]]
        valid = in_bounds & has_density & (nbr_id >= 0)

        u = np.nonzero(valid)[0]
        v = nbr_id[valid]
        nbr_feat = feature_grid[
            nbr_clipped[valid, 0], nbr_clipped[valid, 1], nbr_clipped[valid, 2]
        ]
        l2_colors = np.sqrt(((feat_at[u] - nbr_feat) ** 2).sum(axis=-1))
        # affinity K * exp(-l2_colors / sigma) (reference :284 — the prob term
        # carries coefficient 0.0 there, dropped here)
        w = (K * np.exp(-l2_colors / sigma)).astype(np.float32)
        edge_u_list.append(u.astype(np.int32))
        edge_v_list.append(v.astype(np.int32))
        weight_list.append(w)

    edge_u = np.concatenate(edge_u_list) if edge_u_list else np.zeros(0, np.int32)
    edge_v = np.concatenate(edge_v_list) if edge_v_list else np.zeros(0, np.int32)
    weights = np.concatenate(weight_list) if weight_list else np.zeros(0, np.float32)

    log.info(f"running min-cut: {len(edge_u)} edges", extra={"graph_cut_edges": int(len(edge_u))})
    _, labels = maxflow_mincut(
        num_nodes, edge_u, edge_v, weights, weights, cap_src, cap_snk
    )
    segments = labels.astype(np.int64)
    log.info(
        f"{(segments == 0).sum()} voxels marked as edit, "
        f"{(segments == 1).sum()} as object"
    )
    return segments, idx_values


def _host(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def get_edit_region(
    vol_mod_edit,
    vol_mod_object,
    vol_mod_output,
    downsample_grid: bool = False,
    downsample_factor: int = 4,
    K: float = 5.0,
    sigma: float = 0.1,
    edit_mask_thresh: float = 0.992,
    num_obj_voxels_thresh: int = 5000,
    min_num_edit_voxels: int = 300,
    top_k_edit_thresh: int = 300,
    top_k_obj_thresh: int = 200,
    viz_dir=None,
):
    """Graph-cut the attention grids and write the keep grid (-10 empty /
    -5 object / 0 edit) into `vol_mod_output.grid.attn`, on that grid's
    device. Returns (segments, voxel indices). With `viz_dir`, also writes
    the three 3-D scatter diagnostics (`viz/refinement.py`)."""
    densities = _host(vol_mod_edit.grid.densities)
    if not np.array_equal(densities, _host(vol_mod_object.grid.densities)):
        raise ValueError("density values for edit and object grids don't match")
    features_raw = _host(vol_mod_edit.grid.features)
    if not np.array_equal(features_raw, _host(vol_mod_object.grid.features)):
        raise ValueError("feature values for edit and object grids don't match")

    edit_attn = _host(vol_mod_edit.grid.attn)
    obj_attn = _host(vol_mod_object.grid.attn)
    features = 1.0 / (1.0 + np.exp(-features_raw))  # sigmoid

    segments, idxs = build_graph(
        features, densities, edit_attn, obj_attn,
        K=K, sigma=sigma,
        edit_mask_thresh=edit_mask_thresh,
        num_obj_voxels_thresh=num_obj_voxels_thresh,
        min_num_edit_voxels=min_num_edit_voxels,
        top_k_edit_thresh=top_k_edit_thresh,
        top_k_obj_thresh=top_k_obj_thresh,
        downsample_grid=downsample_grid,
        downsample_factor=downsample_factor,
    )

    factor = downsample_factor if downsample_grid else 1
    if viz_dir is not None and len(idxs):
        from voxe_tpu_torch.viz.refinement import plot_attn_scatter

        coords = np.asarray(idxs) * factor
        ii, jj, kk = coords[:, 0], coords[:, 1], coords[:, 2]
        plot_attn_scatter(
            locations=coords,
            features=features[ii, jj, kk],
            edit_attn=edit_attn[ii, jj, kk, 0],
            object_attn=obj_attn[ii, jj, kk, 0],
            cluster_ids=np.asarray(segments),
            step=0,
            out_dir=viz_dir,
        )

    keep_grid = np.full_like(edit_attn, -10.0)
    keep_grid[densities > 0.0] = -5.0
    # every edit node's factor^3 block of voxels (the JAX package loops over
    # the nodes; at 160^3 that is millions of slice assignments)
    block = np.stack(np.meshgrid(*[np.arange(factor)] * 3, indexing="ij"), axis=-1).reshape(-1, 3)
    cells = (idxs[segments == 0][:, None, :] * factor + block[None]).reshape(-1, 3)
    keep_grid[cells[:, 0], cells[:, 1], cells[:, 2]] = 0.0

    dev = vol_mod_output.grid.densities.device
    vol_mod_output.grid = vol_mod_output.grid.replace(attn=torch.from_numpy(keep_grid).to(dev))
    return segments, idxs


def merge_edit_region(vol_mod_output, vol_mod_ref) -> None:
    """The voxel merge: every voxel outside the edit region (keep grid != 0
    in `vol_mod_output.grid.attn`) takes the reference model's densities and
    features back, in place."""
    keep_mask = _host(vol_mod_output.grid.attn)[..., 0] != 0.0
    new_density = _host(vol_mod_output.grid.densities).copy()
    new_features = _host(vol_mod_output.grid.features).copy()
    new_density[keep_mask] = _host(vol_mod_ref.grid.densities)[keep_mask]
    new_features[keep_mask] = _host(vol_mod_ref.grid.features)[keep_mask]
    dev = vol_mod_output.grid.densities.device
    vol_mod_output.grid = vol_mod_output.grid.replace(
        densities=torch.from_numpy(new_density).to(dev), features=torch.from_numpy(new_features).to(dev)
    )
