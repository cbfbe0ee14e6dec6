"""Port parity for the quality metrics: fenerf_tpu_torch/eval/metrics.py's
KID, Inception Score, PSNR and SSIM against fenerf_tpu.eval.metrics at
1e-6 relative on seeded inputs; the eval_metrics CLI with the stub
extractor against the JAX CLI (its JSON at 1e-6); and the CLI on the
port's InceptionV3 with stand-in weights on the CPU (a directory against
itself: FID below 1e-3 and KID's mean below 1e-4).
"""
import json

import numpy as np
import pytest
from PIL import Image

import torch

from fenerf_tpu.eval import metrics as jm
from fenerf_tpu_torch.eval import metrics as tm

torch.set_num_threads(2)

REL = 1e-6


def _close(a, b):
    assert abs(a - b) <= REL * max(abs(b), 1e-12), (a, b)


def test_kid_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 16)).astype(np.float32)
    y = (rng.standard_normal((30, 16)) + 0.3).astype(np.float32)
    for subsets, size in ((5, 10), (3, 1000)):
        for a, b in zip(tm.kid(x, y, subsets, size), jm.kid(x, y, subsets,
                                                             size)):
            _close(a, b)
    kxx = tm.polynomial_kernel(x, x)
    np.testing.assert_allclose(kxx, jm.polynomial_kernel(x, x), rtol=REL)
    _close(tm.mmd2_unbiased(kxx, kxx, kxx), jm.mmd2_unbiased(kxx, kxx, kxx))


def test_inception_score_matches_jax():
    logits = np.random.default_rng(1).standard_normal((33, 10)) * 3
    for splits in (1, 4, 10):
        for a, b in zip(tm.inception_score(logits, splits),
                        jm.inception_score(logits, splits)):
            _close(a, b)


def test_psnr_ssim_match_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(-1, 1, (3, 20, 18))
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), -1, 1)
    _close(tm.psnr(a, b), jm.psnr(a, b))
    assert tm.psnr(a, a) == float("inf")
    _close(tm.ssim(a, b), jm.ssim(a, b))
    _close(tm.ssim(a[0], b[0], win=5), jm.ssim(a[0], b[0], win=5))


def _dirs(tmp_path, n=6):
    rng = np.random.default_rng(3)
    out = []
    for name in ("real", "gen"):
        d = tmp_path / name
        d.mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (32, 32, 3),
                                         dtype=np.uint8)).save(
                d / f"{i:03d}.png")
        out.append(str(d))
    return out


def test_stub_cli_matches_jax(tmp_path, capsys):
    from fenerf_tpu.apps.eval_metrics import main as jmain
    from fenerf_tpu_torch.apps.eval_metrics import main as tmain

    real, gen = _dirs(tmp_path)
    args = ["--real_dir", real, "--gen_dir", gen, "--metrics", "fid", "kid",
            "isc", "--feature_extractor", "stub", "--kid_subsets", "7",
            "--kid_subset_size", "4"]
    want = jmain(args)
    capsys.readouterr()
    got = tmain(args + ["--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()[0]
    assert json.loads(printed) == got
    assert sorted(got) == sorted(want) == sorted(
        ["fid", "kid_mean", "kid_std", "isc_mean", "isc_std"])
    for k in want:
        _close(got[k], want[k])


def test_inception_cli_on_the_cpu(tmp_path, monkeypatch):
    from fenerf_tpu_torch.apps.eval_metrics import main
    from fenerf_tpu_torch.eval import fid as fidlib
    from fenerf_tpu_torch.nn import inception

    weights = str(tmp_path / "inception.npz")
    inception.export_npz(
        inception.init_inception(torch.Generator().manual_seed(0)), weights)
    monkeypatch.setenv(fidlib.WEIGHTS_ENV, weights)
    real, _ = _dirs(tmp_path, n=3)
    out = main(["--real_dir", real, "--gen_dir", real, "--metrics", "fid",
                "kid", "--kid_subsets", "3", "--device", "cpu"])
    # KID's unbiased estimate on one set against itself is ~0, not 0 (the
    # cross term keeps the diagonal the within-set terms drop)
    assert abs(out["fid"]) < 1e-3 and abs(out["kid_mean"]) < 1e-4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--real_dir", real, "--gen_dir", real])

