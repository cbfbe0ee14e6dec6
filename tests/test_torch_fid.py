"""The port's FID protocol against fenerf_tpu: InceptionV3 (each mixed
block and the pool3 features, up- and downsampling inputs) on stand-in
weights carried between the packages through the shared .npz layout, the
jax.image bilinear resize it starts with, frechet_distance, and the
protocol (the real dump, output_images, calculate_fid) with one feature
function; the scorer CLI and the weights gate.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fenerf_tpu.data import celeba_mask as jdata
from fenerf_tpu.eval import fid as jfid
from fenerf_tpu.nn import inception as jinc
from fenerf_tpu_torch.data import celeba_mask as tdata
from fenerf_tpu_torch.eval import fid as tfid
from fenerf_tpu_torch.eval import score_fid
from fenerf_tpu_torch.nn import inception as tinc
from fenerf_tpu_torch.utils.image import read_png

torch.set_num_threads(2)

# relative to each row's largest |feature|: f32 convolutions summed in
# another order
FEAT_RTOL = 1e-4


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """init_inception stand-ins written by the port's export_npz; -> (path,
    port params, JAX params of the same file)."""
    path = str(tmp_path_factory.mktemp("inception") / "standin.npz")
    tinc.export_npz(tinc.init_inception(torch.Generator().manual_seed(0)),
                    path)
    return path, tinc.load_npz(path), jinc.load_npz(path)


def _rel_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    return (np.abs(a - b).max(axis=1) / np.abs(b).max(axis=1)).max()


def test_npz_layout_round_trip(weights, tmp_path):
    path, tp, jp = weights
    flat_t = {"/".join(map(str, k)): v for k, v in _leaves(tp)}
    with np.load(path) as data:
        assert set(data.files) == set(flat_t)
        assert data["Mixed_5b/branch1x1/w"].shape == (1, 1, 192, 64)
    again = str(tmp_path / "again.npz")
    tinc.export_npz(tp, again)
    with np.load(path) as a, np.load(again) as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def test_inception_from_torch_state_dict(tmp_path):
    """A pytorch-fid style state dict folds BN into (scale, shift) as the
    JAX package folds it."""
    rng = np.random.default_rng(0)
    sd = {}
    specs = {name: (cin, cout, k, k)
             for name, cin, cout, k in tinc._STEM_SPECS}
    for name, kind in tinc.BLOCKS:
        for br, spec in tinc.BLOCK_CONVS[name].items():
            specs[f"{name}.{br}"] = spec
    for prefix, (cin, cout, kh, kw) in specs.items():
        sd[f"{prefix}.conv.weight"] = torch.from_numpy(
            rng.normal(0, 0.05, (cout, cin, kh, kw)).astype(np.float32))
        sd[f"{prefix}.bn.running_mean"] = torch.from_numpy(
            rng.normal(0, 0.1, cout).astype(np.float32))
        sd[f"{prefix}.bn.running_var"] = torch.from_numpy(
            rng.uniform(0.5, 2, cout).astype(np.float32))
        sd[f"{prefix}.bn.weight"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, cout).astype(np.float32))
        sd[f"{prefix}.bn.bias"] = torch.from_numpy(
            rng.normal(0, 0.1, cout).astype(np.float32))
    tp = tinc.inception_from_torch(sd)
    jp = jinc.inception_from_torch(sd)
    for (k, a), (_, b) in zip(_leaves(tp), _leaves(jax.tree.map(
            np.asarray, jp))):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, err_msg=str(k))
    path = str(tmp_path / "sd.npz")
    tinc.export_npz(sd, path)
    with np.load(path) as data:
        np.testing.assert_array_equal(data["Conv2d_1a_3x3/w"],
                                      tp["Conv2d_1a_3x3"]["w"].numpy())


@pytest.mark.parametrize("name,kind", tinc.BLOCKS)
def test_block_matches_jax(weights, name, kind):
    _, tp, jp = weights
    cin = tinc.BLOCK_CONVS[name][next(iter(tinc.BLOCK_CONVS[name]))][0]
    x = np.random.default_rng(1).uniform(0, 1, (2, cin, 9, 9)).astype(
        np.float32)
    ref = {"a": jinc._inception_a, "b": jinc._inception_b,
           "c": jinc._inception_c, "d": jinc._inception_d}
    if kind in ref:
        jy = ref[kind](jp[name], jnp.asarray(x))
    else:
        jy = jinc._inception_e(jp[name], jnp.asarray(x),
                               "max" if kind == "e_max" else "avg")
    ty = tinc.apply_block(tp[name], kind, torch.from_numpy(x))
    assert tuple(ty.shape) == tuple(jy.shape)
    assert _rel_rows(ty.numpy(), jy) < FEAT_RTOL


@pytest.mark.parametrize("src,dst", [(64, 299), (128, 299), (512, 299),
                                     (300, 299), (37, 41)])
def test_resize_matches_jax_image(src, dst):
    x = np.random.default_rng(src).uniform(0, 1, (2, src, src + 3, 3))
    x = x.astype(np.float32)
    jy = jax.image.resize(jnp.asarray(x), (2, dst, dst, 3), "bilinear")
    ty = tinc.resize_bilinear(torch.from_numpy(x), dst)
    # values in [0, 1]: f32 weighted sums over up to 4 taps per axis (more
    # when downsampling), in another order
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)


@pytest.mark.parametrize("size", [64, 512])
def test_pool3_matches_jax(weights, size):
    """Upsampling (64 -> 299) and the antialiased downsampling
    (512 -> 299) of jax.image.resize."""
    _, tp, jp = weights
    x = np.random.default_rng(size).uniform(0, 1, (2, size, size, 3))
    x = x.astype(np.float32)
    jf = np.asarray(jax.jit(jinc.inception_pool3)(jp, jnp.asarray(x)))
    tf = tinc.inception_pool3(tp, torch.from_numpy(x)).numpy()
    assert tf.shape == (2, 2048)
    assert _rel_rows(tf, jf) < FEAT_RTOL


@pytest.mark.parametrize("dim,n", [(8, 40), (64, 16)])
def test_frechet_distance_matches_jax(dim, n):
    rng = np.random.default_rng(dim)
    f1 = rng.normal(size=(n, dim))
    f2 = rng.normal(0.3, 1.2, size=(n, dim))
    a = tfid.fid_from_features(f1, f2)
    b = jfid.fid_from_features(f1, f2)
    assert np.isfinite(a)
    np.testing.assert_allclose(a, b, rtol=1e-6)
    # a set against itself: 0 up to sqrtm's rounding, relative to the trace
    mu, sigma = tfid.feature_statistics(f1)
    assert abs(tfid.frechet_distance(mu, sigma, mu, sigma)) \
        < 1e-6 * np.trace(sigma)


def _projection(seed=0):
    """A fixed feature function for both packages: 4 x 4 means of each
    channel through a random projection to 16 dims."""
    w = np.random.default_rng(seed).normal(size=(48, 16))

    def features(imgs):
        imgs = np.asarray(imgs, np.float64)
        n, h, wd, _ = imgs.shape
        pooled = imgs[:, :h // 4 * 4, :wd // 4 * 4].reshape(
            n, 4, h // 4, 4, wd // 4, 3).mean(axis=(2, 4))
        return pooled.reshape(n, 48) @ w

    return features


@pytest.fixture(scope="module")
def mask_tree(tmp_path_factory):
    from PIL import Image

    from fenerf_tpu_torch.data.synthetic import label_map

    root = tmp_path_factory.mktemp("fidtree")
    (root / "celebahq_mask_img").mkdir()
    (root / "celebahq_mask_mask").mkdir()
    rng = np.random.default_rng(4)
    for i in range(5):
        img = rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)
        Image.fromarray(img).save(root / "celebahq_mask_img" / f"{i}.jpg",
                                  quality=90)
        Image.fromarray(label_map(rng, 24), "L").save(
            root / "celebahq_mask_mask" / f"{i}.png")
    return str(root)


@pytest.mark.parametrize("size,target", [(32, 32), (16, 24)])
def test_protocol_matches_jax(mask_tree, tmp_path, size, target):
    """The real dump (resized to target_size when it differs) pixel-equal
    to JAX's; the FID of the dumps against rendered images through one
    feature function within 1e-6 of JAX's."""
    name = "CelebAMaskHQ_wo_background_seg_18"
    jds = jdata.make_dataset(name, mask_tree, size, use_native=False)
    tds = tdata.make_dataset(name, mask_tree, size)
    jreal, treal = str(tmp_path / "jreal"), str(tmp_path / "treal")
    jfid.setup_evaluation(jds, jreal, target_size=target, num_real=4)
    tfid.setup_evaluation(tds, treal, target_size=target, num_real=4)
    from PIL import Image

    names = sorted(os.listdir(treal))
    assert names == sorted(os.listdir(jreal)) and len(names) == 4
    for n in names:
        np.testing.assert_array_equal(
            read_png(os.path.join(treal, n)),
            np.asarray(Image.open(os.path.join(jreal, n))))

    def render(g, n):
        return torch.rand((n, 3, target, target), generator=g) * 2 - 1

    gen_dir = str(tmp_path / "gen")
    tfid.output_images(render, gen_dir, num_eval=6, batch_size=4)
    assert len(os.listdir(gen_dir)) == 6
    feats = _projection()
    a = tfid.calculate_fid(treal, gen_dir, feature_fn=feats, batch_size=3)
    b = jfid.calculate_fid(jreal, gen_dir, feature_fn=feats, batch_size=3)
    assert np.isfinite(a)
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_weights_gate_and_scorer(weights, tmp_path, monkeypatch, capsys):
    path, _, _ = weights
    monkeypatch.delenv(tfid.WEIGHTS_ENV, raising=False)
    with pytest.raises(FileNotFoundError, match=tfid.WEIGHTS_ENV):
        tfid.inception_features(device="cpu")
    if not torch.cuda.is_available():
        monkeypatch.setenv(tfid.WEIGHTS_ENV, path)
        with pytest.raises(RuntimeError, match="CUDA"):
            tfid.inception_features()
    rng = np.random.default_rng(0)
    for sub in ("a", "b"):
        d = tmp_path / sub
        d.mkdir()
        from fenerf_tpu_torch.utils.image import save_png

        for i in range(3):
            save_png(str(d / f"{i}.png"),
                     rng.integers(0, 256, (24, 24, 3), dtype=np.uint8))
    out = score_fid.main(["--real", str(tmp_path / "a"), "--gen",
                          str(tmp_path / "a"), "--weights", path,
                          "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"fid", "images", "score_s", "device"}
    assert line["images"] == 6 and abs(out["fid"]) < 1e-3
