"""The port's data path against PIL and fenerf_tpu.data.celeba_mask: the
native baseline-JPEG decoder (data/native/codec.cpp) against PIL's decode
(4:2:0, 4:2:2, 4:4:4, grey, restart markers, odd sizes; the fixture set by
its digests), refusals of other JPEG kinds, the native PNG unfilter
against read_png's Python version, the dataset items of every registry
entry against the JAX package's PIL path, and iterate_batches against the
JAX loader for the same seeds and host sharding. Small images: each case
decodes a few KB.
"""
import hashlib
import io
import os

import numpy as np
import pytest
from PIL import Image

from fenerf_tpu.data import celeba_mask as jdata
from fenerf_tpu_torch.data import celeba_mask as tdata
from fenerf_tpu_torch.data import native_loader as nl
from fenerf_tpu_torch.data import synthetic
from fenerf_tpu_torch.utils import image as timage


def _smooth(rng, h, w, c=3):
    """Smooth content plus grain, uint8 (the kind of data JPEG keeps)."""
    base = rng.uniform(0, 255, (h // 8 + 2, w // 8 + 2, c)).astype(np.uint8)
    img = np.asarray(Image.fromarray(base.squeeze(-1) if c == 1 else base)
                     .resize((w, h), Image.BICUBIC), np.float32)
    img = img.reshape(h, w, c) + rng.normal(0, 12, (h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


def _jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **{"quality": 90, **kw})
    return buf.getvalue()


def _pil(data):
    im = Image.open(io.BytesIO(data))
    return np.asarray(im if im.mode == "L" else im.convert("RGB"))


def _held_to_pil(data):
    out, ref = nl.decode_jpeg(data), _pil(data)
    assert out.shape == ref.shape
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    # equality is the aim; the stated bound is |d| <= 1 on >= 99% equal
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    assert np.array_equal(out, ref), f"max |d| {diff.max()}"


# PIL's subsampling: 0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("size", [(64, 64), (37, 53), (100, 77), (9, 3),
                                  (8, 8)])
def test_jpeg_decode_equals_pil(size, subsampling):
    rng = np.random.default_rng(size[0] * 7 + subsampling)
    img = _smooth(rng, max(size[0], 8), max(size[1], 8))[:size[0], :size[1]]
    _held_to_pil(_jpeg(img, subsampling=subsampling))


@pytest.mark.parametrize("kw", [dict(restart_marker_blocks=1),
                                dict(restart_marker_blocks=3),
                                dict(restart_marker_rows=1)])
@pytest.mark.parametrize("subsampling", [0, 2])
def test_jpeg_restart_markers(kw, subsampling):
    rng = np.random.default_rng(5)
    data = _jpeg(_smooth(rng, 61, 83), subsampling=subsampling, **kw)
    assert b"\xff\xdd" in data  # a DRI segment: restart intervals on
    _held_to_pil(data)


@pytest.mark.parametrize("size", [(64, 48), (37, 53)])
def test_jpeg_grey(size):
    rng = np.random.default_rng(3)
    data = _jpeg(_smooth(rng, *size, c=1)[..., 0])
    out = nl.decode_jpeg(data)
    assert out.ndim == 2
    _held_to_pil(data)


def test_fixture_set_matches_its_digests():
    digests = synthetic.fixture_digests()
    assert len(digests) == 8
    for name, digest in digests.items():
        out = nl.read_image(str(synthetic.FIXTURES / name), "RGB")
        assert out.shape == (1024, 1024, 3)
        assert hashlib.sha256(out.tobytes()).hexdigest() == digest, name
    size = sum(os.path.getsize(p) for p in synthetic.FIXTURES.iterdir())
    assert size < 2 * 2 ** 20


@pytest.mark.parametrize("kind,kw,match", [
    ("progressive", dict(progressive=True), "progressive"),
    ("not a jpeg", None, "not a JPEG"),
    ("truncated", dict(), "truncated|without image data"),
])
def test_jpeg_refusals(kind, kw, match):
    rng = np.random.default_rng(1)
    if kw is None:
        data = b"\x89PNG\r\n\x1a\n" + bytes(32)
    else:
        data = _jpeg(_smooth(rng, 32, 32), **kw)
        if kind == "truncated":
            data = data[:200]
    with pytest.raises(ValueError, match=match):
        nl.decode_jpeg(data)


def _filtered(rng, rows, stride, bpp):
    """Random scanlines, each with filter type row % 5, in PNG's raw
    layout (the bytes are arbitrary: unfiltering is defined on any)."""
    raw = rng.integers(0, 256, (rows, stride + 1), dtype=np.uint8)
    raw[:, 0] = np.arange(rows) % 5
    return raw


@pytest.mark.parametrize("bpp", [1, 3, 4])
def test_png_unfilter_equals_python(bpp):
    rng = np.random.default_rng(bpp)
    raw = _filtered(rng, 23, 17 * bpp, bpp)
    np.testing.assert_array_equal(nl.unfilter_png(raw, bpp),
                                  timage.unfilter_rows(raw, bpp))
    raw[4, 0] = 7
    with pytest.raises(ValueError, match="filter type 7"):
        nl.unfilter_png(raw, bpp)


@pytest.mark.parametrize("mode", ["L", "P", "RGB"])
def test_read_png_equals_pil(tmp_path, mode):
    rng = np.random.default_rng(2)
    labels = (_smooth(rng, 45, 38, c=1)[..., 0] // 14).astype(np.uint8)
    if mode == "RGB":
        img = Image.fromarray(timage.CELEBA_PALETTE[labels % 19])
    else:
        img = Image.fromarray(labels, "L")
        if mode == "P":
            img = img.convert("P")
    path = str(tmp_path / "m.png")
    img.save(path, optimize=True)
    for conv in ("L", "RGB"):
        np.testing.assert_array_equal(
            nl.read_image(path, conv),
            np.asarray(Image.open(path).convert(conv)))


# ---------------------------------------------------------------------------
# Datasets and the loader against the JAX package's PIL path
# ---------------------------------------------------------------------------

N_ITEMS = 6


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A CelebAMask-HQ-layout tree: JPEG and PNG images (64 x 48, not
    square) and label masks at another size (32 x 24, classes 0-18), plus
    the single-image variant's demo pair."""
    root = tmp_path_factory.mktemp("celebamask")
    rng = np.random.default_rng(0)
    for sub in ("celebahq_mask_img", "celebahq_mask_mask", "png_img",
                "demo_mask_img", "demo_mask_mask"):
        (root / sub).mkdir()
    for i in range(N_ITEMS):
        img = _smooth(rng, 64, 48)
        (root / "celebahq_mask_img" / f"{i}.jpg").write_bytes(
            _jpeg(img, subsampling=2))
        Image.fromarray(img).save(root / "png_img" / f"{i}.png")
        mask = synthetic.label_map(rng, 32)[:, 4:28]
        Image.fromarray(mask, "L").save(root / "celebahq_mask_mask"
                                        / f"{i}.png")
    (root / "demo_mask_img" / "97.jpg").write_bytes(
        (root / "celebahq_mask_img" / "1.jpg").read_bytes())
    (root / "demo_mask_mask" / "97.png").write_bytes(
        (root / "celebahq_mask_mask" / "1.png").read_bytes())
    return str(root)


@pytest.mark.parametrize("name,kw", [
    ("CelebAMaskHQ_wo_background_seg_18", dict(background_mask=True)),
    ("CelebAMaskHQ_wo_background_seg_18", dict(background_mask=False)),
    ("CelebAMaskHQ", dict(background_mask=True)),
    ("CelebAMaskHQ_single_image_wo_background_seg_18", {}),
])
@pytest.mark.parametrize("size", [16, 32])
def test_mask_dataset_items_match_jax(tree, name, kw, size):
    jds = jdata.make_dataset(name, tree, size, use_native=False, **kw)
    tds = tdata.make_dataset(name, tree, size, **kw)
    assert len(jds) == len(tds)
    for i in range(len(tds)):
        for flip in (False, True):
            jx, jl = jds.__getitem__(i, flip=flip)
            tx, tl = tds.__getitem__(i, flip=flip)
            np.testing.assert_array_equal(tl, jl)
            np.testing.assert_allclose(tx, jx, atol=2 / 255, rtol=0)
            np.testing.assert_array_equal(tx, jx)


def test_png_images_are_exact(tree):
    kw = dict(img_glob="png_img/*.png")
    jds = jdata.CelebAMaskDataset(tree, 32, use_native=False, **kw)
    tds = tdata.CelebAMaskDataset(tree, 32, **kw)
    for i in range(len(tds)):
        for a, b in zip(tds.__getitem__(i, flip=True),
                        jds.__getitem__(i, flip=True)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["CelebA", "Cats", "Carla"])
def test_rgb_datasets_match_jax(tree, name):
    pattern = os.path.join(tree, "celebahq_mask_img", "*.jpg")
    jds = jdata.make_dataset(name, pattern, 16)
    tds = tdata.make_dataset(name, pattern, 16)
    for i in range(len(tds)):
        for flip in (False, True):
            for a, b in zip(tds.__getitem__(i, flip=flip),
                            jds.__getitem__(i, flip=flip)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,host_index,n_hosts", [(0, 0, 1), (3, 1, 2)])
def test_iterate_batches_match_jax(tree, seed, host_index, n_hosts):
    """The same batches, in the same order, over two epochs and more."""
    jds = jdata.make_dataset("CelebAMaskHQ_wo_background_seg_18", tree, 16,
                             use_native=False)
    tds = tdata.make_dataset("CelebAMaskHQ_wo_background_seg_18", tree, 16)
    kw = dict(seed=seed, host_index=host_index, n_hosts=n_hosts)
    bs = 2 if n_hosts == 1 else 1
    jit = jdata.iterate_batches(jds, bs, **kw)
    timings = []
    tit = tdata.iterate_batches(tds, bs, timings=timings, **kw)
    batches = []
    for _ in range(7):
        (jx, jl), (tx, tl) = next(jit), next(tit)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(tl, jl)
        batches.append(tx)
    jit.close()
    tit.close()
    assert len(timings) >= 7
    # skip: a resumed loader starts at the straight run's batch
    tit = tdata.iterate_batches(tds, bs, skip=4, **kw)
    np.testing.assert_array_equal(next(tit)[0], batches[4])
    tit.close()


def test_codec_build_failure_raises(monkeypatch, tmp_path):
    """No fallback: a compiler that fails makes the first use raise."""
    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nl, "_LIB", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building codec.cpp failed"):
        nl.library()
