"""Port parity for face parsing: fenerf_tpu_torch/nn/bisenet.py against
fenerf_tpu.nn.bisenet on a seeded state_dict in segNet-20Class.pth's key
layout (stand_in_state_dict), converted by the JAX package's
bisenet_from_torch and loaded by the port: the resize matrices exact, the
align-corners resize, the logits at 64^2 (f32, 1e-4 of the largest),
remap_labels exact; and the prepare_segmaps CLI against the JAX CLI on two
committed 1024^2 fixture JPEGs at --size 64: equal label PNGs wherever the
logits' top-two margin exceeds the tolerance, equal previews there.
"""
import numpy as np
import pytest
from PIL import Image

import jax.numpy as jnp
import torch

from fenerf_tpu.nn import bisenet as jb
from fenerf_tpu_torch.data import synthetic
from fenerf_tpu_torch.nn import bisenet as tb

torch.set_num_threads(2)

# the logits, relative to each image's largest: f32 convolutions in another
# order
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def state_dict():
    return tb.stand_in_state_dict(0)


@pytest.mark.parametrize("n_in,n_out", [(1, 5), (7, 13), (16, 64), (5, 3),
                                        (64, 64)])
def test_interp_matrix_exact(n_in, n_out):
    np.testing.assert_array_equal(tb._interp_matrix(n_in, n_out),
                                  jb._interp_matrix(n_in, n_out))


def test_resize_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 7, 5)).astype(
        np.float32)
    ref = np.asarray(jb.resize_bilinear_ac(jnp.asarray(x), (13, 9)))
    out = tb.resize_bilinear_ac(torch.from_numpy(x), (13, 9)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    # align_corners=True: F.interpolate's own
    want = torch.nn.functional.interpolate(
        torch.from_numpy(x), (13, 9), mode="bilinear",
        align_corners=True).numpy()
    np.testing.assert_allclose(out, want, atol=1e-5)


def test_stand_in_layout_is_the_reference_one(state_dict):
    # the JAX converter reads every key it needs; the auxiliary heads ride
    # along as in segNet-20Class.pth
    jb.bisenet_from_torch(state_dict)
    assert state_dict["conv_out.conv_out.weight"].shape == (20, 256, 1, 1)
    assert "conv_out16.conv_out.weight" in state_dict
    assert "cp.resnet.layer1.0.downsample.0.weight" not in state_dict
    assert state_dict["cp.resnet.layer4.0.downsample.0.weight"].shape == (
        512, 256, 1, 1)


def test_logits_match_jax(state_dict):
    x = np.random.default_rng(1).standard_normal((2, 3, 64, 64)).astype(
        np.float32)
    ref = np.asarray(jb.bisenet_apply(jb.bisenet_from_torch(state_dict),
                                      jnp.asarray(x)))
    out = tb.bisenet_apply(tb.bisenet_from_torch(state_dict),
                           torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 20, 64, 64)
    scale = np.abs(ref).max(axis=(1, 2, 3), keepdims=True)
    assert (np.abs(out - ref) / scale).max() <= LOGIT_TOL
    assert len(np.unique(ref.argmax(1))) > 2


def test_remap_labels_exact():
    m = np.random.default_rng(2).integers(0, 20, (9, 11)).astype(np.uint8)
    np.testing.assert_array_equal(tb.remap_labels(m), jb.remap_labels(m))
    out = tb.remap_labels(np.arange(20, dtype=np.uint8))
    assert out[0] == 0 and out[2] == 6 and out[14] == 3 and out[19] == 14
    assert tb.REMAP_FFHQ_TO_CELEBA == jb.REMAP_FFHQ_TO_CELEBA


def _grey(path):
    return np.asarray(Image.open(path))


def test_prepare_segmaps_cli_matches_jax(state_dict, tmp_path):
    from fenerf_tpu.apps.prepare_segmaps import main as jmain
    from fenerf_tpu_torch.apps.prepare_segmaps import main as tmain
    from fenerf_tpu_torch.utils.mask_tools import colorize

    images = tmp_path / "photos"
    images.mkdir()
    names = sorted(synthetic.fixture_digests())[:2]
    for n in names:
        (images / n).symlink_to(synthetic.FIXTURES / n)
    weights = str(tmp_path / "segNet-20Class.pth")
    torch.save(state_dict, weights)
    common = ["--images", str(images / "*.jpg"), "--weights", weights,
              "--size", "64", "--colorize"]
    jmain(common + ["--output_dir", str(tmp_path / "j")])
    res = tmain(common + ["--output_dir", str(tmp_path / "t"), "--device",
                          "cpu"])
    assert len(res["files"]) == 2 and len(res["model_ms"]) == 2
    # the margin of the JAX package's logits on the same input
    params = jb.bisenet_from_torch(state_dict)
    for n in names:
        stem = n.rsplit(".", 1)[0]
        img = Image.open(images / n).convert("RGB").resize((64, 64),
                                                           Image.BILINEAR)
        x = (np.asarray(img, np.float32) / 255.0).transpose(2, 0, 1)[None]
        logits = np.asarray(jb.bisenet_apply(params,
                                             jnp.asarray((x - 0.5) / 0.5)))
        top = np.sort(logits[0], axis=0)
        sure = top[-1] - top[-2] > LOGIT_TOL * np.abs(logits).max()
        ref, out = (_grey(tmp_path / d / f"{stem}.png") for d in "jt")
        assert out.dtype == np.uint8 and out.shape == ref.shape == (64, 64)
        assert sure.mean() > 0.99
        np.testing.assert_array_equal(out[sure], ref[sure])
        cref, cout = (np.asarray(Image.open(
            tmp_path / d / f"{stem}_color.png").convert("RGB"))
            for d in "jt")
        np.testing.assert_array_equal(cout[sure], cref[sure])
        np.testing.assert_array_equal(cout, colorize(out))


def test_prepare_segmaps_needs_weights_and_cuda(tmp_path, state_dict,
                                                monkeypatch):
    from fenerf_tpu_torch.apps.prepare_segmaps import main

    with pytest.raises(SystemExit, match="parsing weights not found"):
        main(["--images", "x/*.jpg", "--output_dir", str(tmp_path),
              "--weights", str(tmp_path / "missing.pth")])
    weights = str(tmp_path / "w.pth")
    torch.save(state_dict, weights)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--images", "x/*.jpg", "--output_dir", str(tmp_path),
              "--weights", weights])
