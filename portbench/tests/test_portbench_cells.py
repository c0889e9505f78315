"""Each cell at a small size on the CPU: the program against the plain
reference, the control and the planted faults coming out not correct, and
no JAX module in a run's process.

The program runs in float32 here (its configuration's bfloat16 parts
raised), so that it meets the reference to rounding; the cells' limits are
the ones the card runs are held to."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench.lib import check, faults
from portbench.lib.manifest import ROOT, Cell, load_manifest, merge
from portbench.reference.precision import Rounding
from portbench.run import run
from portbench.tests.tiny import OVERRIDES

CELLS = [w["name"] for w in load_manifest()["workloads"]]
F32 = {"config": {"grid": {"gather_dtype": "float32"}, "sd": {"dtypes": {"unet": "float32", "vae": "float32"}}}}
SEED = 2**31 + 12345  # larger than 32 signed bits hold


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny(cell: str, f32: bool = True) -> dict:
    return merge(OVERRIDES[cell], F32) if f32 else OVERRIDES[cell]


@pytest.mark.parametrize("cell", CELLS)
def test_program_meets_the_reference(cell):
    result, compared = run(cell, SEED, 0.2, False, "cpu", _tiny(cell))
    assert result["correct"], compared
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "check" and set(result["check"]) == set(Cell(cell).spec["limits"])
    assert {"setup_s"} < set(result["metrics"])
    for v in compared.values():
        assert v["value"] < 1e-3  # float32 on both sides: rounding only


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference in float8 where the configuration says bfloat16, in
    the program's place."""
    c = Cell(cell, overrides=_tiny(cell, f32=False))
    ref = c.entry.reference(c.config, c.spec, SEED, "cpu", Rounding("f32"))
    control = c.entry.reference(c.config, c.spec, SEED, "cpu", Rounding("fp8"))
    assert not check.judge(check.gaps(control, ref), c.spec["limits"])


FAULTS = [pytest.param(cell, fault, id=f"{fault}-{cell}")
          for cell in CELLS for fault in ["unchanged", *Cell(cell).entry.FAULTS]]


@pytest.mark.parametrize("cell, fault", FAULTS)
def test_planted_fault_is_not_correct(cell, fault):
    with faults.plant(Cell(cell).entry, fault):
        result, compared = run(cell, SEED + 1, 0.1, False, "cpu", _tiny(cell))
    assert not result["correct"], compared


def test_run_loads_no_jax_module():
    code = (
        "import json, torch; torch.set_num_threads(1)\n"
        "from portbench.run import run, forbidden_modules\n"
        "from portbench.tests.tiny import OVERRIDES\n"
        "run('recon-160', 7, 0.1, False, 'cpu', OVERRIDES['recon-160'])\n"
        "import portbench.reference.steps, sys\n"
        "print(json.dumps(forbidden_modules()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_reference_alone_loads_nothing_of_the_program():
    code = ("import sys, portbench.reference.steps, portbench.reference.sd\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'voxe_tpu_torch', 'voxe_tpu', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr[-2000:]


def test_no_card_means_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_cells_on_the_card():
    """Every cell at its own size on the card, a short window: correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in CELLS:
        result, compared = run(cell, SEED + 2, 2.0, False, "cuda")
        assert result["correct"], (cell, compared)
