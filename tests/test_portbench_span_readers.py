"""portbench/lib/spans.py on a hand-built Chrome trace: host operators on
the step's thread and on an autograd engine thread, forward and backward
operators linked by sequence numbers, launches and kernels sharing a
correlation, and the program's `voxe.*` annotations. Also the host records'
reading and the span tool on a small cell on the CPU."""
from __future__ import annotations

import copy

import pytest
import torch

from portbench.lib import spans, trace

MAIN, ENGINE = 101, 202


def _x(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur, "args": args}


def _op(name, tid, ts, dur, seq=None, fwd=None):
    args = {} if seq is None else {"Sequence number": seq, "Fwd thread id": fwd or 0}
    return _x("cpu_op", name, tid, ts, dur, **args)


def _launch(tid, ts, corr):
    return _x("cuda_runtime", "cudaLaunchKernel", tid, ts, 1.0, correlation=corr)


def _kernel(name, ts, dur, corr):
    return _x("kernel", name, 0, ts, dur, correlation=corr, stream=7)


def _span(name, tid, ts, dur):
    return _x("user_annotation", name, tid, ts, dur)


def _events():
    """One step: the render's forward (a mul and the compositing op), an add
    outside the render, then the backward on an engine thread: the mul's
    backward, the compositing op's backward re-differentiating a cumprod,
    and the leaf's AccumulateGrad; and a kernel whose launch is missing."""
    return [
        _span("voxe.step", MAIN, 0.0, 100.0),
        _span("voxe.render", MAIN, 10.0, 20.0),
        _span("voxe.backward", MAIN, 50.0, 40.0),
        # forward, on the step's thread
        _op("aten::mul", MAIN, 12.0, 2.0, seq=5), _launch(MAIN, 13.0, 1), _kernel("mul_fwd", 20.0, 5.0, 1),
        _op("_CompositeWeights", MAIN, 15.0, 5.0, seq=7), _op("aten::empty", MAIN, 16.0, 1.0),
        _launch(MAIN, 18.0, 6), _kernel("composite_fwd_kernel", 26.0, 2.0, 6),
        _op("aten::add", MAIN, 35.0, 2.0, seq=8), _launch(MAIN, 36.0, 3), _kernel("add_fwd", 38.0, 2.0, 3),
        # backward, on the engine's thread
        _op("autograd::engine::evaluate_function: MulBackward0", ENGINE, 55.0, 8.0, seq=5, fwd=1),
        _op("MulBackward0", ENGINE, 55.5, 7.0, seq=5, fwd=1), _op("aten::mul", ENGINE, 56.0, 3.0),
        _launch(ENGINE, 57.0, 2), _kernel("mul_bwd", 58.0, 4.0, 2),
        _op("_CompositeWeightsBackward", ENGINE, 64.0, 14.0, seq=7, fwd=1),
        _op("aten::cumprod", ENGINE, 65.0, 1.0, seq=0), _launch(ENGINE, 65.5, 7),
        _kernel("cumprod_refwd", 66.0, 1.0, 7),
        _op("CumprodBackward0", ENGINE, 68.0, 6.0, seq=0, fwd=2), _op("aten::cumsum", ENGINE, 69.0, 2.0),
        _launch(ENGINE, 70.0, 5), _kernel("cumsum_bwd", 71.0, 3.0, 5),
        _op("torch::autograd::AccumulateGrad", ENGINE, 80.0, 2.0), _launch(ENGINE, 81.0, 4),
        _kernel("accumulate", 83.0, 1.0, 4),
        _kernel("no_launch", 92.0, 1.0, 99),
    ]


def _laid(events):
    return {k: round(v * 1e6, 6) for k, v in spans.lay(events)["span_device_s"].items()}


def test_forward_kernels_go_to_their_span():
    laid = _laid(_events())
    # mul_fwd 5 + composite 2 in the render; add 2 in the step
    assert laid["voxe.step"] == pytest.approx(2.0)
    assert laid["voxe.render"] >= 7.0


def test_backward_kernels_go_to_the_forward_span_by_sequence_number():
    out = spans.lay(_events())
    laid = {k: round(v * 1e6, 6) for k, v in out["span_device_s"].items()}
    # render: mul_fwd 5, composite 2, mul_bwd 4 (seq 5 -> the forward mul), and the
    # re-differentiation's cumprod 1 and cumsum 3 (seq 0 on the engine -> the
    # cumprod inside _CompositeWeightsBackward, seq 7 -> _CompositeWeights)
    assert laid["voxe.render"] == pytest.approx(15.0)
    assert laid["voxe.backward"] == pytest.approx(1.0)  # AccumulateGrad: no forward
    assert out["outside_s"] == 0.0


def test_a_kernel_without_its_launch_is_unattributed():
    out = spans.lay(_events())
    assert out["unattributed_s"] * 1e6 == pytest.approx(1.0)
    assert out["device_s"] * 1e6 == pytest.approx(19.0)
    assert sum(out["span_device_s"].values()) + out["unattributed_s"] == pytest.approx(out["device_s"])


def test_a_backward_thread_is_matched_by_its_votes_not_by_a_shared_sequence_number():
    events = _events()
    # the engine's id 2 gets its vote from a pair whose sequence number only the engine holds ...
    events += [_op("aten::sub", ENGINE, 66.2, 0.1, seq=1), _op("SubBackward0", ENGINE, 75.0, 1.0, seq=1, fwd=2)]
    # ... so a later operator of the step's thread with the cumprod's number 0 is not its forward
    events.append(_op("aten::rand", MAIN, 66.5, 0.2, seq=0))
    assert _laid(events)["voxe.render"] == pytest.approx(15.0)
    unvoted = [e for e in events if e["name"] != "SubBackward0"]
    assert _laid(unvoted)["voxe.render"] == pytest.approx(12.0)  # the cumsum then falls to the later operator


def test_idle_gaps_go_to_the_innermost_span():
    idle = {k: round(v * 1e6, 6) for k, v in spans.lay(_events())["span_idle_s"].items()}
    # window 12 .. 93 (first host operator to the last device operation);
    # busy 20-25, 26-28, 38-40, 58-62, 66-67, 71-74, 83-84, 92-93
    assert idle["voxe.render"] == pytest.approx(8.0 + 1.0)  # 12-20, 25-26
    assert idle["voxe.step"] == pytest.approx(10.0 + 18.0)  # 28-38, 40-58 (middle 49)
    assert idle["voxe.backward"] == pytest.approx(4.0 + 4.0 + 9.0 + 8.0)  # 62-66, 67-71, 74-83, 84-92


def test_reduce_reads_the_same_with_and_without_the_annotations():
    events = _events()
    bare = [e for e in copy.deepcopy(events) if e["cat"] != "user_annotation"]
    assert trace.reduce(events) == trace.reduce(bare)
    assert spans.lay(bare)["span_device_s"] == {}


def test_host_times_take_self_and_sync_time():
    records = [("step", -1, 0, 100), ("render", 0, 10, 40), ("sync.render.geometry", 1, 12, 15),
               ("sd.unet", 0, 50, 90), ("sync.unet.t", 3, 50, 70), ("sync.render.geometry", 1, 20, 21)]
    host = spans.host_times(records)
    assert host["step"] == pytest.approx((1, 100e-9, 30e-9, 24e-9))
    assert host["render"] == pytest.approx((1, 30e-9, 26e-9, 4e-9))
    assert host["sd.unet"] == pytest.approx((1, 40e-9, 20e-9, 20e-9))
    assert host["sync.render.geometry"] == pytest.approx((2, 4e-9, 4e-9, 0.0))


def test_the_span_tool_on_a_small_cell_on_the_cpu():
    from portbench import spans as tool
    from portbench.tests.tiny import OVERRIDES

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = tool.measure("recon-160", 2**31 + 99, 1, 2, device="cpu", overrides=OVERRIDES["recon-160"])
    finally:
        torch.set_num_threads(threads)
    # the CPU's plain compositing backward counts one read a step (one pass a render)
    assert r["host_syncs_per_step"] == r["sync_debug"]["counted_per_step"] == 8
    assert r["laid_share"] is None and r["card"] == "cpu"  # no device operation on the CPU
    assert {"voxe.step", "voxe.render", "voxe.loss", "voxe.backward", "voxe.optim"} <= set(r["spans"])
    assert r["spans"]["voxe.render"]["calls"] == 1 and r["spans"]["voxe.render"]["host_ms"] > 0
    with_spans, without = r["profiled"]["with_spans"], r["profiled"]["without_spans"]
    assert len(with_spans) == len(without) == 2


CELL_OF = {"edit": "edit-sd2", "refine": "refine-sd14", "recon": "recon-160", "xl": "edit-sdxl"}


@pytest.mark.parametrize("metric", ["host_syncs_per_step", "sync_wait_ms"])
@pytest.mark.parametrize("kind", sorted(CELL_OF))
def test_sync_readers_read_the_program_counters(metric, kind, monkeypatch):
    from portbench.lib.manifest import Cell, counters_of, reader
    from portbench.lib.trace import Trace
    from portbench.metrics.lib import syncs
    from portbench.run import _counter_values, _snapshot
    from voxe_tpu_torch.utils import tracing

    name = f"{metric}.{kind}"
    assert name in {m["name"] for m in Cell(CELL_OF[kind]).per_layer()}
    module = reader(name)
    counters = counters_of({name: module})
    before = _snapshot(counters)
    for _ in range(3):
        tracing.upload([1.0], "probe")
    values = _counter_values(counters, before, _snapshot(counters))
    tr = Trace([], 0.0, 0.0, 3, 1.0, values, {}, {})
    got = module.read(tr)
    if metric == "host_syncs_per_step":
        assert values == {"host_syncs": 3} and got == 1.0
    else:
        assert got == values["sync_wait_ns"] * 1e-6 / 3 and got > 0.0
    assert syncs.SYNCS == tracing.SYNCS and syncs.SYNC_NS == tracing.SYNC_NS

    # a program without the tracing module: the counters read 0, the reader None
    real = syncs.importlib.import_module

    def missing(mod):
        if mod == syncs.MODULE:
            raise ModuleNotFoundError(mod)
        return real(mod)

    monkeypatch.setattr(syncs.importlib, "import_module", missing)
    before = _snapshot(counters)
    values = _counter_values(counters, before, _snapshot(counters))
    assert set(values.values()) == {0} and not syncs.present()
    assert module.read(Trace([], 0.0, 0.0, 3, 1.0, values, {}, {})) is None


@pytest.mark.parametrize("kind", ["edit", "refine"])
def test_unet_replay_readers_read_the_program_counters(kind, monkeypatch):
    from portbench.lib.manifest import Cell, counters_of, reader
    from portbench.lib.trace import Trace
    from portbench.metrics.lib import unet_graph
    from portbench.run import _counter_values, _snapshot
    from voxe_tpu_torch.utils import tracing

    name = f"unet_replay_pct.{kind}"
    assert name in {m["name"] for m in Cell(CELL_OF[kind]).per_layer()}
    assert name not in {m["name"] for m in Cell("recon-160").per_layer()}
    module = reader(name)
    counters = counters_of({name: module})

    def read(calls, replays):
        before = _snapshot(counters)
        monkeypatch.setattr(tracing, "UNET_CALLS", tracing.UNET_CALLS + calls)
        monkeypatch.setattr(tracing, "UNET_REPLAYS", tracing.UNET_REPLAYS + replays)
        values = _counter_values(counters, before, _snapshot(counters))
        assert values == {"unet_calls": calls, "unet_replays": replays}
        return module.read(Trace([], 0.0, 0.0, 5, 1.0, values, {}, {}))

    assert read(5, 5) == 100.0
    assert read(4, 3) == 75.0
    assert read(0, 0) is None  # no UNet call in the window

    def read_absent():
        before = _snapshot(counters)
        values = _counter_values(counters, before, _snapshot(counters))
        assert set(values.values()) == {0} and not unet_graph.present()
        return module.read(Trace([], 0.0, 0.0, 5, 1.0, values, {}, {}))

    # the commit before the counters: its tracing module lacks them
    monkeypatch.delattr(tracing, "UNET_REPLAYS")
    assert read_absent() is None

    # a program without the tracing module
    real = unet_graph.importlib.import_module

    def missing(mod):
        if mod == unet_graph.MODULE:
            raise ModuleNotFoundError(mod)
        return real(mod)

    monkeypatch.setattr(unet_graph.importlib, "import_module", missing)
    assert read_absent() is None
