"""The frozen arithmetic of the per-layer metrics against hand-worked
numbers at the cells' shapes, and the trace reduction on a small trace."""
from __future__ import annotations

import json

import pytest

from portbench.lib import trace as tracing
from portbench.lib.manifest import ROOT
from portbench.metrics.lib import opcount, readers

SD2 = json.loads((ROOT / "portbench/configs/dog2-sd2.json").read_text())
SD14 = json.loads((ROOT / "portbench/configs/dog2-sd14.json").read_text())


def test_flash_call_at_the_edit_shape():
    shape = opcount.flash_shape(SD2["sd"])
    assert shape == (2, 4096, 5, 64)
    # q k^T and p v: 2 x 2 x B h L^2 d = 4 x 2 x 5 x 4096^2 x 64 = 42.9 GFLOP; Q, K, V, O: 4 x 5.24 MB
    assert 4 * 2 * 5 * 4096**2 * 64 == pytest.approx(42.95e9, rel=1e-3)
    assert opcount.flash_fwd_bound_s(shape) == pytest.approx(42.95e9 / 989e12, rel=1e-3)  # compute-bound
    assert 4 * 2 * 4096 * 5 * 64 * 2 / 3.35e12 < opcount.flash_fwd_bound_s(shape)
    assert opcount.flash_fwd_bound_s(shape) * 1e3 == pytest.approx(0.0434, rel=1e-2)


def test_composite_call_at_the_recon_shape():
    assert opcount.composite_bytes(589824, 256) == pytest.approx(1.817e9, rel=1e-3)
    assert opcount.composite_bound_s(589824, 256) * 1e3 == pytest.approx(0.542, rel=1e-3)


def test_step_flops_add_up_from_their_parts():
    unet = opcount.unet_flops(SD2["sd"]["unet"], 64)
    vae = opcount.vae_encoder_flops(SD2["sd"]["vae"], 512)
    render = opcount.render_flops(160, 384, 3)
    assert render == 2 * 160 * 384 * 160 * 160 * 4 + 2 * 160 * 384 * 384 * 160 * 4
    assert opcount.edit_step_flops(SD2) == pytest.approx(2 * render + 2 * vae + 2 * unet)
    assert 0.7e12 < unet < 0.9e12 and 1.0e12 < vae < 1.2e12  # SD's published ~0.8 TFLOP a UNet pass at 64^2
    assert opcount.refine_step_flops(SD14) < opcount.edit_step_flops(SD2)
    # the first conv of the VAE encoder: 3 -> 128 channels, 3x3, at 512^2
    assert opcount.conv(3, 128, 3, 512) == 2 * 3 * 128 * 9 * 512 * 512


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduction_counts_overlap_once_and_lays_gaps_to_the_host():
    events = [
        _event("cpu_op", "aten::outer", 0.0, 100.0),
        _event("cpu_op", "aten::inner", 40.0, 20.0),
        _event("kernel", "k1", 10.0, 20.0),
        _event("kernel", "k2", 20.0, 20.0),  # overlaps k1 on another stream
        _event("gpu_memcpy", "copy", 70.0, 10.0),
        _event("kernel", "k1", 90.0, 10.0),
    ]
    out = tracing.reduce(events)
    assert len(out["kernels"]) == 3
    assert out["busy_s"] == pytest.approx(50e-6)  # [10, 40] + [70, 80] + [90, 100]
    assert out["window_s"] == pytest.approx(100e-6)
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps["aten::inner"] == pytest.approx(30e-6)  # the gap [40, 70] mid-point 55 is inside aten::inner
    assert gaps["aten::outer"] == pytest.approx(20e-6)  # [0, 10] and [80, 90]
    ops = dict(out["breakdown"]["device_ops"])
    assert ops["k1"] == pytest.approx(30e-6)


def test_readers_find_nothing_and_return_none():
    t = tracing.Trace([], 0.0, 0.0, 5, 100.0, {"flash_fwd_launches": 0}, SD2, {})
    assert readers.launches_per_step(t) is None and readers.device_idle_pct(t) is None
    assert readers.roofline(t, "flash_fwd_kernel", 0, 1e-5) is None
    t.kernels = [("flash_fwd_kernel<64>", 0.0, 100.0)] * 5
    assert readers.roofline(t, "flash_fwd_kernel", 4, 1e-5) is None  # the counter disagrees
    assert readers.roofline(t, "flash_fwd_kernel", 5, 43.4e-6) == pytest.approx(43.4)


def test_idle_share_is_against_the_untraced_step():
    """5 traced steps with 0.25 s of device time, 100 ms a step untraced:
    half the step idle, whatever the profiler did to the traced window."""
    t = tracing.Trace([("k", 0.0, 1.0)], 0.25, 0.9, 5, 100.0, {}, SD2, {})
    assert readers.device_idle_pct(t) == pytest.approx(50.0)
