"""The editing loop's steps_per_call > 1 branches against voxe_tpu's fused
branches on the CPU (a file of its own, so that `--dist loadfile` runs it
beside test_torch_edit.py)."""
import pytest

from tests.test_torch_edit import _check_driver_outputs, _run_drivers, sd_pair, tiny_scene  # noqa: F401 (fixtures)
from voxe_tpu_torch.train import sds as tsds


@pytest.mark.parametrize("mode", ["random", "random_exact", "data_pose"])
def test_fused_edit_loop_matches_jax(tmp_path, tiny_scene, sd_pair, monkeypatch, mode):
    """`steps_per_call = 2` over 5 steps against the JAX fused branches:
    random poses on the shear-warp and the exact renderer (through
    `make_sds_train_multi_step`, a 2-step and a 1-step call), and dataset
    poses (the data step in a loop, batches chosen per step). SDS off, so
    the losses do not depend on the poses, which the port draws from its
    own generator in random mode. The saves follow the fused cadence
    (`step % 3 < 2` and the last step: iterations 4 and 5, not 1 and 3),
    and the final grids agree."""
    calls = []
    multi_step = tsds.make_sds_train_multi_step

    def spy(*args, **kwargs):
        calls.append((args[4], kwargs["use_shear_warp"]))
        return multi_step(*args, **kwargs)

    monkeypatch.setattr(tsds, "make_sds_train_multi_step", spy)
    jout, tout, start = _run_drivers(
        tmp_path, tiny_scene, sd_pair, num_iterations=5, save_freq=3, steps_per_call=2,
        data_pose_mode=mode == "data_pose", use_shear_warp=mode != "random_exact",
    )
    _check_driver_outputs(tmp_path, jout, tout, start, ["model_final.pth", "model_iter_4.pth", "model_iter_5.pth"])
    sw = mode != "random_exact"
    assert calls == ([] if mode == "data_pose" else [(2, sw), (2, sw), (1, sw)])
