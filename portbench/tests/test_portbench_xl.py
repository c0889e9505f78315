"""The SDXL cell at a small size on the CPU (`tiny_xl.py`; the cells'
shared test file takes its small sizes from `tiny.py`): the program against
the plain reference, the control and the planted faults coming out not
correct, and the SDXL FLOP count and flash shape against hand-worked
numbers at the published widths."""
from __future__ import annotations

import json

import pytest
import torch

from portbench.lib import check, faults
from portbench.lib.manifest import ROOT, Cell, merge
from portbench.metrics.lib import opcount, opcount_xl
from portbench.reference.precision import Rounding
from portbench.run import run
from portbench.tests.tiny_xl import F32, OVERRIDES

CELL = "edit-sdxl"
SEED = 2**31 + 54321
SDXL = json.loads((ROOT / "portbench/configs/dog2-sdxl.json").read_text())


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_program_meets_the_reference():
    result, compared = run(CELL, SEED, 0.2, False, "cpu", merge(OVERRIDES[CELL], F32))
    assert result["correct"] and result["failed"] == 0, compared
    assert {"setup_s", "edit_step_ms", "peak_mem_gib"} == set(result["metrics"])
    for v in compared.values():
        assert v["value"] < 1e-3  # float32 on both sides: rounding only


def test_control_is_not_correct():
    c = Cell(CELL, overrides=OVERRIDES[CELL])
    ref = c.entry.reference(c.config, c.spec, SEED, "cpu", Rounding("f32"))
    control = c.entry.reference(c.config, c.spec, SEED, "cpu", Rounding("fp8"))
    assert not check.judge(check.gaps(control, ref), c.spec["limits"])


@pytest.mark.parametrize("fault", ["unchanged", *Cell(CELL).entry.FAULTS])
def test_planted_fault_is_not_correct(fault):
    with faults.plant(Cell(CELL).entry, fault):
        result, compared = run(CELL, SEED + 1, 0.1, False, "cpu", OVERRIDES[CELL])
    assert not result["correct"], compared


def test_sdxl_flops_and_flash_shape_at_the_published_widths():
    sd = SDXL["sd"]
    assert opcount_xl.flash_shape(sd) == (2, 4096, 10, 64)  # the first level with attention, not level 0
    assert opcount.flash_fwd_bound_s(opcount_xl.flash_shape(sd)) * 1e3 == pytest.approx(0.0869, rel=1e-3)
    unet = opcount_xl.unet_flops(sd["unet"], 128)
    vae = opcount.vae_encoder_flops(sd["vae"], 1024)
    # torch.utils.flop_counter on the meta-device reference reads 6.76123639808e12 and 4.87895072768e12
    assert unet == pytest.approx(6.76123639808e12, rel=1e-9) and vae == pytest.approx(4.87895072768e12, rel=1e-9)
    render = opcount.render_flops(160, 384, 3)
    assert opcount_xl.edit_step_flops(SDXL) == pytest.approx(2 * render + 2 * vae + 2 * unet)
    # one depth-1 level reads as opcount's SD 1.x / 2.x transformer
    assert opcount_xl._transformer(640, 64, 1024, 1) == opcount._transformer(640, 64, 1024)
