"""The port's evaluation suite (voxe_tpu_torch/evaluation and
voxe_tpu_torch/cli/calculate_metrics.py) against evaluation/ on the CPU:
the metric math at 1e-9 on seeded numpy inputs, the Inception and CLIP
embedders on tests/test_evaluation.py's seeded random-weight fixtures
(features within 1e-5), and both CLIs on two copies of one result tree
(1 scene, 1 prompt folder, 3 images of 64^2): the CSV layout first, then
every float within 1e-6 relative; without weights the files are
byte-identical."""
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from evaluation import metrics_lib as jmetrics
from tests.test_evaluation import _build_results_tree, _write_images, make_clip_fixture_dir, make_inception_fixture_dir
from voxe_tpu_torch.cli import calculate_metrics as tcli
from voxe_tpu_torch.evaluation import metrics_lib as tmetrics

# One intra-op thread: the suite runs in parallel worker processes, where
# torch's per-core thread pools oversubscribe the cores and spin.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inception_dir(tmp_path_factory):
    return make_inception_fixture_dir(tmp_path_factory.mktemp("inception"))


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    return make_clip_fixture_dir(tmp_path_factory.mktemp("clip"))


def _spd(rng, k):
    a = rng.standard_normal((k, k))
    return a @ a.T + 0.1 * np.eye(k)


def test_metric_math_matches_jax_package():
    """frechet_distance (a full-rank and a singular pair), both CLIP
    similarities and get_psnrs, on seeded inputs, within 1e-9."""
    rng = np.random.default_rng(0)
    mu1, mu2 = rng.standard_normal(6), rng.standard_normal(6)
    s1, s2 = _spd(rng, 6), _spd(rng, 6)
    low = rng.standard_normal((3, 6))
    singular = low.T @ low  # rank 3: the jitter branch
    for args in ((mu1, s1, mu2, s2), (mu1, singular, mu2, singular), (mu1, s1, mu1, s1)):
        assert tmetrics.frechet_distance(*args) == pytest.approx(jmetrics.frechet_distance(*args), rel=1e-9, abs=1e-9)
    img, text = rng.standard_normal((5, 16)), rng.standard_normal((1, 16))
    assert tmetrics.avg_clip_text_sim(img, text) == pytest.approx(jmetrics.avg_clip_text_sim(img, text), abs=1e-9)
    feats = [rng.standard_normal(s) for s in ((1, 16), (5, 16), (1, 16), (5, 16))]
    assert tmetrics.avg_clip_directional_sim(*feats) == pytest.approx(jmetrics.avg_clip_directional_sim(*feats),
                                                                      abs=1e-9)
    imgs = [Image.fromarray(rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)) for _ in range(4)]
    got, want = tmetrics.get_psnrs(imgs[:2], imgs[2:]), jmetrics.get_psnrs(imgs[:2], imgs[2:])
    assert type(got) is type(want) and got == pytest.approx(want, rel=1e-9)


def test_inception_embedder_matches_jax_package(tmp_path, inception_dir):
    """Pool3 features of 2 images (the port embeds them as one batch, the
    JAX package one at a time) within 1e-5, and the strict load of the
    torchvision-layout state dict."""
    _write_images(tmp_path / "a", seed=0, n=2)
    imgs = tmetrics.get_images(tmp_path / "a")
    got = tmetrics.InceptionEmbedder(inception_dir, device="cpu").features(imgs)
    want = jmetrics.InceptionEmbedder(inception_dir).features(imgs)
    assert got.shape == (2, 2048) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_clip_scorer_matches_jax_package(tmp_path, clip_dir):
    _write_images(tmp_path / "imgs", seed=2, n=2)
    imgs = tmetrics.get_images(tmp_path / "imgs")
    got, want = tmetrics.ClipScorer(clip_dir, device="cpu"), jmetrics.ClipScorer(clip_dir)
    for a, b in ((got.image_features(imgs), want.image_features(imgs)),
                 (got.text_features("a render of a yarn doll"), want.text_features("a render of a yarn doll"))):
        assert a.shape == b.shape and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())


def test_column_fields_follow_pandas():
    """The CSV's float fields are pandas' (float32 columns keep float32's
    shortest repr, mixed ones are float64; NaN is empty)."""
    import io

    import pandas as pd

    cols = {"a": [np.float32(0.1) * 3, np.float32(35.12345)], "b": [float("nan"), 1e-20],
            "c": [1.0, np.float32(2.1)], "d": [float("nan"), float("nan")]}
    buf = io.StringIO()
    pd.DataFrame(cols, index=["x", "y,z"]).to_csv(buf)
    rows = buf.getvalue().splitlines()[1:]
    fields = {k: tcli._column_fields(v) for k, v in cols.items()}
    assert rows == ['x,0.3,,1.0,', '"y,z",35.12345,1e-20,2.0999999046325684,'] and [
        [f[i] for f in fields.values()] for i in range(2)] == [["0.3", "", "1.0", ""],
                                                               ["35.12345", "1e-20", "2.0999999046325684", ""]]


def _run_both(tmp_path, flags):
    """Both CLIs on two copies of one tree: (port CSV text, JAX CSV text)."""
    from click.testing import CliRunner

    from evaluation.calculate_metrics import main as jmain

    tree = _build_results_tree(tmp_path / "jax")
    shutil.copytree(tree, tmp_path / "port")
    res = CliRunner().invoke(jmain, ["-d", str(tree), *flags], catch_exceptions=False)
    assert res.exit_code == 0, res.output
    out = tcli.main(["-d", str(tmp_path / "port"), *flags, "--device", "cpu"])
    assert out == tmp_path / "port" / "output_metrics.csv"
    assert (tmp_path / "port" / "dog2" / "recon" / "frame_0.png").exists()  # "color_" stripped
    return out.read_text(), (tree / "output_metrics.csv").read_text()


def test_cli_without_weights_is_byte_identical(tmp_path):
    got, want = _run_both(tmp_path, [])
    assert got == want
    assert want.splitlines()[2].startswith("yarn_doll,,,,,")  # CLIP and FID NaN: empty fields


def _low_rank_sqrtm(a: np.ndarray, sqrtm) -> np.ndarray:
    """The principal square root of a low-rank `a` (a product of two
    covariances of 3 samples: rank 2) by scipy's own `sqrtm` on its
    restriction to a basis holding its row and column spaces: a = Q C Q^T
    exactly, so sqrtm(a) = Q sqrtm(C) Q^T (sqrt(0) = 0). At 2048^2 scipy's
    sqrtm takes 28 s on one core; this takes milliseconds. Refuses an `a`
    the basis does not hold."""
    omega = np.random.default_rng(0).standard_normal((a.shape[0], 8))
    q, _ = np.linalg.qr(np.concatenate([a @ omega, a.T @ omega], axis=1))
    c = q.T @ a @ q
    assert np.abs(q @ c @ q.T - a).max() <= 1e-9 * np.abs(a).max()
    return q @ sqrtm(c) @ q.T


def test_cli_with_weights_matches_jax_cli(tmp_path, clip_dir, inception_dir, monkeypatch):
    """With the CLIP and Inception fixtures every column is computed: the
    same lines and fields, each float within 1e-6 relative (PSNR equal).
    Both CLIs take FID's matrix square root through `_low_rank_sqrtm`
    (scipy's `sqrtm` on the rank-2 product's restriction); the Frechet
    distance with scipy's own sqrtm is held in
    test_metric_math_matches_jax_package."""
    from scipy import linalg

    monkeypatch.setattr(linalg, "sqrtm", lambda a, sqrtm=linalg.sqrtm: _low_rank_sqrtm(a, sqrtm))
    got, want = _run_both(tmp_path, ["--clip_model_dir", str(clip_dir), "--inception_model_dir", str(inception_dir)])
    g_lines, w_lines = got.splitlines(), want.splitlines()
    assert len(g_lines) == len(w_lines) == 4 and g_lines[:2] == w_lines[:2] and g_lines[3] == w_lines[3] == ""
    assert g_lines[1] == ",text CLIP,dir CLIP,FID recon,FID input,PSNR recon"
    g_row, w_row = g_lines[2].split(","), w_lines[2].split(",")
    assert g_row[0] == w_row[0] == "yarn_doll" and len(g_row) == len(w_row) == 6
    for name, g, w in zip(tcli.COLUMNS, g_row[1:], w_row[1:]):
        assert w != "" and float(g) == pytest.approx(float(w), rel=1e-6, abs=1e-9), name
    assert g_row[-1] == w_row[-1]


def test_clip_flag_without_transformers_fails_at_once(tmp_path, monkeypatch):
    tree = _build_results_tree(tmp_path / "results")
    monkeypatch.setitem(sys.modules, "transformers", None)  # import raises ImportError
    with pytest.raises(RuntimeError, match="transformers"):
        tcli.main(["-d", str(tree), "--clip_model_dir", str(tmp_path), "--device", "cpu"])
    assert not (tree / "output_metrics.csv").exists()
    assert (Path(tree) / "dog2" / "recon" / "color_frame_0.png").exists()  # nothing touched
