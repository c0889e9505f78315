"""voxe_tpu_torch/utils/tracing.py: spans off cost nothing and record
nothing; recorded spans nest; under torch.profiler they are `voxe.*`
annotations; `scalar` and `upload` return what the plain calls return and
count each call; each program counter is a module-level int (a set) that
`count` raises, `counted` reads as a delta and a capture's tally adds at each
replay; each trainer step records its spans once a step and computes the
same bits with recording on and off."""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.lib.manifest import Cell
from portbench.lib.spans import host_times
from portbench.tests.tiny import OVERRIDES
from voxe_tpu_torch.utils import tracing

torch.set_num_threads(1)
SEED = 2**31 + 4242


@pytest.fixture(autouse=True)
def _recording_off():
    tracing.record(False)
    tracing.take()
    yield
    tracing.record(False)
    tracing.take()


def test_span_off_is_the_shared_noop_and_records_nothing():
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("render") is tracing.NULL
    with tracing.span("render"):
        with tracing.span("sync.x"):
            pass
    assert tracing.take() == []


def test_recorded_spans_nest_with_self_time_and_take_clears():
    tracing.record(True)
    with tracing.span("step"):
        with tracing.span("render"):
            with tracing.span("sync.render.geometry"):
                pass
        with tracing.span("loss"):
            pass
    tracing.record(False)
    records = tracing.take()
    assert [(name, parent) for name, parent, _, _ in records] == [
        ("step", -1), ("render", 0), ("sync.render.geometry", 1), ("loss", 0)]
    assert all(t1 >= t0 > 0 for _, _, t0, t1 in records)
    step, render, sync, loss = records
    assert step[2] <= render[2] <= sync[2] <= sync[3] <= render[3] <= loss[2] <= loss[3] <= step[3]
    host = host_times(records)  # self time leaves out the children's
    incl = {name: t1 - t0 for name, _, t0, t1 in records}
    step_self = incl["step"] - incl["render"] - incl["loss"]
    assert host["step"][:3] == pytest.approx((1, incl["step"] * 1e-9, step_self * 1e-9))
    assert host["render"][2:] == pytest.approx(((incl["render"] - incl["sync.render.geometry"]) * 1e-9,
                                                incl["sync.render.geometry"] * 1e-9))
    assert tracing.take() == []


def test_take_refuses_inside_an_open_span():
    tracing.record(True)
    with tracing.span("step"):
        with pytest.raises(RuntimeError):
            tracing.take()


def test_spans_are_user_annotations_under_the_profiler():
    x = torch.ones(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("render"):
            tracing.scalar(x.sum(), "probe")
    names = [e.key for e in prof.key_averages()]
    assert "voxe.render" in names and "voxe.sync.probe" in names
    assert tracing.take() == []  # the profiler alone records nothing on the host clock


def test_traced_keeps_the_function_and_its_result():
    @tracing.traced("loss")
    def f(a, b=2):
        """doc"""
        return a * b

    assert f(3, b=4) == 12 and f.__name__ == "f" and f.__doc__ == "doc"
    tracing.record(True)
    f(1)
    tracing.record(False)
    assert [r[0] for r in tracing.take()] == ["loss"]


@pytest.mark.parametrize("x, plain", [
    (torch.tensor(37.25), float),
    (torch.tensor(-3, dtype=torch.int64), int),
    (torch.tensor(5.0) > 0, bool),
    (torch.arange(6, dtype=torch.float64).reshape(2, 3), lambda t: t.cpu()),
])
def test_scalar_returns_the_plain_read_and_counts_it(x, plain):
    before = tracing.SYNCS
    got = tracing.scalar(x, "probe")
    assert tracing.SYNCS == before + 1
    want = plain(x)
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want)
    else:
        assert type(plain(got)) is type(want) and plain(got) == want and got == want


def test_upload_returns_as_tensor_and_counts_host_values():
    values = np.arange(9, dtype=np.float64).reshape(3, 3)
    before, waited = tracing.SYNCS, tracing.SYNC_NS
    got = tracing.upload(values, "probe", dtype=torch.float32, device="cpu")
    assert torch.equal(got, torch.as_tensor(values, dtype=torch.float32))
    assert tracing.upload([1.0, 2.0], "probe").dtype == torch.float32
    assert tracing.SYNCS == before + 2 and tracing.SYNC_NS > waited


# every program counter that portbench's metrics or the tests read, where
# they read it, and three values to count: eagerly, then twice under a capture
INT_VALUES = (3, 5, 7)
PROGRAM_COUNTERS = [
    ("voxe_tpu_torch.ops.flash_attention", "LAUNCHES", INT_VALUES),
    ("voxe_tpu_torch.ops.flash_attention", "LAUNCHES_BWD", INT_VALUES),
    ("voxe_tpu_torch.ops.flash_attention", "REFERENCE_ON_CUDA", INT_VALUES),
    ("voxe_tpu_torch.ops.group_norm", "LAUNCHES", INT_VALUES),
    ("voxe_tpu_torch.ops.group_norm", "REFERENCE_ON_CUDA", INT_VALUES),
    ("voxe_tpu_torch.ops.composite", "LAUNCHES", INT_VALUES),
    ("voxe_tpu_torch.ops.composite", "LAUNCHED_SHAPES", ({(1, 2)}, {(3, 4)}, {(3, 4), (5, 6)})),
    ("voxe_tpu_torch.ops.composite", "LAUNCHES_SUMS", INT_VALUES),
    ("voxe_tpu_torch.ops.composite", "LAUNCHES_BWD", INT_VALUES),
    ("voxe_tpu_torch.ops.composite", "LAUNCHED_BWD_SHAPES",
     ({(1, 2, 3, 2, True, True)}, {(4, 5, 2, 2, False, True)}, {(4, 5, 2, 2, False, True), (6, 7, 6, 4, True, True)})),
] + [("voxe_tpu_torch.utils.tracing", name, INT_VALUES) for name in (
    "SYNCS", "SYNC_NS", "UNET_CALLS", "UNET_REPLAYS", "ATTN_FLASH_FLOPS", "ATTN_SDPA_FLOPS", "ATTN_PROBS_FLOPS")]


def _total(values):
    return set().union(*values) if isinstance(values[0], set) else sum(values)


@pytest.mark.parametrize("module, name, values", PROGRAM_COUNTERS,
                         ids=[f"{m.rsplit('.', 1)[-1]}.{n}" for m, n, _ in PROGRAM_COUNTERS])
def test_program_counter_counts_reads_and_replays(monkeypatch, module, name, values):
    home = importlib.import_module(module)
    held = getattr(home, name)
    assert type(held) is type(values[0])
    monkeypatch.setattr(home, name, held)  # restored after the test
    key = f"{module.rsplit('.', 1)[-1]}.{name}"
    assert key in tracing.COUNTERS
    eager, *captured = values
    with tracing.counted() as c:
        tracing.count(key, eager, torch.device("cpu"))  # never asks CUDA: this torch has none
        assert c[key] == eager
        with monkeypatch.context() as m:  # a card whose current stream is being captured
            m.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
            with tracing.captured() as tally:
                for value in captured:
                    tracing.count(key, value, torch.device("cuda"))
            with pytest.raises(RuntimeError):
                tracing.count(key, eager, torch.device("cuda"))  # captured with no tally open
        assert c[key] == eager and tally == {key: _total(captured)}
        tracing.replayed(tally)
        tracing.replayed(tally)
    tracing.count(key, eager)  # after the block: not in it
    assert c[key] == _total([eager] + captured + captured)
    assert getattr(home, name) == _total([held, eager] + captured + captured + [eager])


# each trainer step's spans a step (recon's draw is the view's pick)
SPANS = {
    "edit-sd2": {"step": 1, "draw": 1, "render": 1, "sd.encode": 1, "sd.unet": 1, "loss": 1, "backward": 1,
                 "optim": 1},
    "refine-sd14": {"step": 1, "draw": 1, "render": 2, "sd.encode": 1, "sd.unet": 1, "sd.maps": 1, "loss": 1,
                    "backward": 1, "optim": 1},
    "recon-160": {"step": 1, "draw": 1, "render": 1, "loss": 1, "backward": 1, "optim": 1},
}
# host syncs a step on the CPU, each through `tracing`; the recon step's
# render composites once (colour and diffuse in one pass), so the plain
# compositing backward counts its one read (the card's kernels make none)
SYNCS = {"edit-sd2": 13, "refine-sd14": 24, "recon-160": 8}


def _run(cell: str, steps: int, recording: bool):
    c = Cell(cell, overrides=OVERRIDES[cell])
    session = c.entry.setup(c.config, c.spec, SEED, "cpu")
    tracing.record(recording)
    before = tracing.SYNCS
    metrics = [session.step() for _ in range(steps)]
    tracing.record(False)
    return metrics, {k: v.detach().clone() for k, v in session.leaves.items()}, tracing.take(), tracing.SYNCS - before


@pytest.mark.parametrize("cell", sorted(SPANS))
def test_trainer_step_spans_and_the_same_bits_with_recording(cell):
    steps = 2
    m_off, leaves_off, records_off, syncs_off = _run(cell, steps, False)
    m_on, leaves_on, records_on, syncs_on = _run(cell, steps, True)
    assert records_off == []
    calls = {}
    for name, _, _, _ in records_on:
        calls[name] = calls.get(name, 0) + 1
    layers = {k: v for k, v in calls.items() if not k.startswith("sync.")}
    assert layers == {k: v * steps for k, v in SPANS[cell].items()}
    assert sum(v for k, v in calls.items() if k.startswith("sync.")) == syncs_on == syncs_off == SYNCS[cell] * steps
    by_index = {i: r for i, r in enumerate(records_on)}
    for name, parent, _, _ in records_on:  # every span but the step sits inside a step
        while parent >= 0 and by_index[parent][0] != "step":
            parent = by_index[parent][1]
        assert (parent >= 0) == (name != "step"), name
    for a, b in zip(m_off, m_on):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k
    for k in leaves_off:
        assert torch.equal(leaves_off[k], leaves_on[k]), k


@pytest.mark.parametrize("cell", sorted(SPANS))
def test_spans_add_no_operator_under_the_profiler(cell):
    """The same step, from the same seed, profiled with the spans and with
    `span` returning its no-op: the same host operators, so the same
    launches on a card."""
    ops = {}
    for with_spans in (True, False):
        c = Cell(cell, overrides=OVERRIDES[cell])
        session = c.entry.setup(c.config, c.spec, SEED, "cpu")
        patch = pytest.MonkeyPatch()
        if not with_spans:
            patch.setattr(tracing, "span", lambda _name: tracing.NULL)
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                session.step()
        finally:
            patch.undo()
        names = [e.name for e in prof.events()]
        ops[with_spans] = sorted(n for n in names if not n.startswith("voxe."))
        assert any(n.startswith("voxe.") for n in names) == with_spans
    assert ops[True] == ops[False]
