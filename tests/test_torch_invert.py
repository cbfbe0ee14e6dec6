"""Port parity for the inversion: its helpers (one_hot_mask, miou), the
PNG reader and PIL-exact resizes that replace PIL on the card, the targets,
one step's loss and offset gradients against jax.value_and_grad of the same
loss built from fenerf_tpu's public functions, the optimizer against the
optax chain, and LPIPS at stand-in weights. Tiny sizes (TINY_KW, 16^2, 4
steps). The CLI runs in tests/test_torch_invert_cli.py."""
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp
import optax
import torch

from fenerf_tpu.apps import invert as jinv
from fenerf_tpu.eval import lpips as jlpips
from fenerf_tpu.models import generator as jgen
from fenerf_tpu.nn import fields as jfields
from fenerf_tpu_torch.apps import invert as tinv
from fenerf_tpu_torch.compat.jax_bridge import from_numpy_tree
from fenerf_tpu_torch.eval import lpips as tlpips
from fenerf_tpu_torch.models import generator as tgen
from fenerf_tpu_torch.nn import fields as tfields
from fenerf_tpu_torch.train.loop import AdamState
from fenerf_tpu_torch.utils import image as timage

torch.set_num_threads(2)

FLAGSHIP = "TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96"
TINY_KW = dict(z_geo_dim=8, z_app_dim=8, hidden_dim=16, map_hidden_dim=16,
               grid_resolution=8, grid_channels=4)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


# ---------------------------------------------------------------------------
# helpers, PNG, resize, targets
# ---------------------------------------------------------------------------

def test_one_hot_mask_and_miou_equal_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 19, (23, 17))
    b = rng.integers(0, 19, (23, 17))
    for n, skip in ((18, True), (19, False)):
        np.testing.assert_array_equal(tinv.one_hot_mask(a, n, skip),
                                      jinv.one_hot_mask(a, n, skip))
    sa = tinv.one_hot_mask(a, 19, False)[None]
    sb = tinv.one_hot_mask(b, 19, False)[None]
    assert tinv.miou(sa, sb) == jinv.miou(sa, sb)
    assert tinv.miou(sa, sa) == pytest.approx(1.0, abs=1e-5)


def _filtered_png(path, img, color, palette=None):
    """Write `img` as an 8-bit PNG whose scanline y uses filter type y % 5
    (None, Sub, Up, Average, Paeth), so every filter is decoded."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * bpp).astype(np.int32)
    out = bytearray()
    prior = np.zeros(w * bpp, np.int32)
    for y in range(h):
        kind, x = y % 5, rows[y]
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(x)
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (a + prior) >> 1
        else:
            p = a + prior - c
            pa, pb, pc = abs(p - a), abs(p - prior), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prior, c))
        out += bytes([kind]) + ((x - pred) % 256).astype(np.uint8).tobytes()
        prior = x

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
    if palette is not None:
        body += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    body += chunk(b"IDAT", zlib.compress(bytes(out)))
    with open(path, "wb") as f:
        f.write(timage.PNG_MAGIC + body + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P"])
def test_read_png_equals_pil(mode, tmp_path):
    rng = np.random.default_rng(1)
    h, w = 21, 19
    channels = {"L": 1, "RGB": 3, "RGBA": 4, "P": 1}[mode]
    # smooth plus noise: every filter predicts something non-trivial
    ramp = np.add.outer(np.arange(h) * 7, np.arange(w) * 5)
    img = (ramp[..., None] * (1 + np.arange(channels))
           + rng.integers(0, 40, (h, w, channels))) % 256
    img = img.astype(np.uint8).squeeze()
    palette = rng.integers(0, 256, (256, 3)) if mode == "P" else None
    color = {"L": 0, "RGB": 2, "RGBA": 6, "P": 3}[mode]
    path = str(tmp_path / "a.png")
    _filtered_png(path, img, color, palette)
    pil = Image.open(path)
    assert pil.mode == mode
    np.testing.assert_array_equal(np.asarray(pil), img)   # the file is right
    out = timage.read_png(path)
    ref = np.asarray(pil.convert("RGB")) if mode == "P" else np.asarray(pil)
    np.testing.assert_array_equal(out, ref)
    for m in ("RGB", "L"):
        np.testing.assert_array_equal(timage.to_mode(out, m),
                                      np.asarray(pil.convert(m)))
    # and a file PIL wrote, with its own filter choices
    pil.save(str(tmp_path / "b.png"), optimize=True)
    np.testing.assert_array_equal(
        timage.read_png(str(tmp_path / "b.png")),
        np.asarray(Image.open(str(tmp_path / "b.png")).convert(
            "RGB" if mode == "P" else mode)))


def test_read_png_refuses_other_files(tmp_path):
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(
        str(tmp_path / "a.jpg"))
    with pytest.raises(ValueError, match="not a PNG"):
        timage.read_png(str(tmp_path / "a.jpg"))
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(
        str(tmp_path / "d.png"))
    with pytest.raises(ValueError, match="unsupported PNG"):
        timage.read_png(str(tmp_path / "d.png"))


def test_png_writer_round_trips(tmp_path):
    rng = np.random.default_rng(2)
    for img in (rng.integers(0, 256, (5, 7, 3), np.uint8),
                rng.integers(0, 19, (6, 4), np.uint8)):
        timage.save_png(str(tmp_path / "x.png"), img)
        np.testing.assert_array_equal(
            np.asarray(Image.open(str(tmp_path / "x.png"))), img)
        np.testing.assert_array_equal(
            timage.read_png(str(tmp_path / "x.png")), img)


@pytest.mark.parametrize("src,dst", [((37, 53), (16, 16)),
                                     ((64, 64), (23, 31)),
                                     ((17, 9), (97, 101)),
                                     ((320, 427), (256, 341))])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_equals_pil(src, dst, channels):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, src + (channels,), np.uint8).squeeze()
    pil = Image.fromarray(img)
    for method, pm in (("nearest", Image.NEAREST),
                       ("bilinear", Image.BILINEAR)):
        ref = np.asarray(pil.resize(dst, pm))
        np.testing.assert_array_equal(timage.resize(img, dst, method), ref)


@pytest.mark.parametrize("size,bg", [((64, 64), None), ((70, 90), "black"),
                                     ((90, 70), "white")])
def test_load_targets_equal_jax(size, bg, tmp_path):
    rng = np.random.default_rng(4)
    h, w = size
    img_p, seg_p = str(tmp_path / "gt.png"), str(tmp_path / "seg.png")
    Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(img_p)
    # a label map of another size takes the NEAREST resize first
    Image.fromarray(rng.integers(0, 19, (h // 2, w // 2), np.uint8),
                    mode="L").save(seg_p)
    kw = dict(background_mask=bg == "black",
              white_background_mask=bg == "white")
    ref = jinv.load_targets(img_p, seg_p, 16, **kw)
    out = tinv.load_targets(img_p, seg_p, 16, **kw)
    np.testing.assert_array_equal(out[1], ref[1])          # gt18
    np.testing.assert_array_equal(out[2], ref[2])          # gt19
    np.testing.assert_allclose(out[0], ref[0], atol=1 / 127.5, rtol=0)
    assert out[0].shape == (1, 3, 16, 16) and out[2].shape == (1, 19, 256, 256)


# ---------------------------------------------------------------------------
# one inversion step against jax.value_and_grad
# ---------------------------------------------------------------------------

def test_step_loss_and_offset_gradients_match_jax():
    jcfg = jfields.get_config(FLAGSHIP, **TINY_KW)
    tcfg = tfields.get_config(FLAGSHIP, **TINY_KW)
    jp = jfields.init_field(jax.random.key(0), jcfg)
    jp["sigma_head"]["b"] = jp["sigma_head"]["b"] + 5.0   # opaque volume
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(5)
    (fg, pg), (fa, pa) = jfields.field_film(
        jp, jcfg, jnp.asarray(rng.standard_normal((1, 8)), jnp.float32),
        jnp.asarray(rng.standard_normal((1, 8)), jnp.float32))
    w = {"geo": (np.asarray(fg), np.asarray(pg)),
         "app": (np.asarray(fa), np.asarray(pa))}
    small = lambda x, s: (rng.standard_normal(x.shape) * s).astype(np.float32)
    offsets = {br: tuple(small(x, 0.05) for x in w[br]) for br in w}
    noise = {br: tuple(small(x, 0.02) for x in w[br]) for br in w}
    gt_img = rng.uniform(-1, 1, (1, 3, 16, 16)).astype(np.float32)
    gt18 = rng.uniform(-1, 1, (1, 18, 16, 16)).astype(np.float32)
    lam = dict(seg=1.0, img=0.7, norm=1.3)
    key = jax.random.key(7)
    render = dict(img_size=16, num_steps=4, hierarchical=False,
                  h_stddev=0.0, v_stddev=0.0, sample_dist=None)
    jr = jgen.RenderConfig(**render)

    def jloss(offsets):     # fenerf_tpu/apps/invert.py:225-241
        film = {br: tuple(a + n + o for a, n, o in
                          zip(w[br], noise[br], offsets[br])) for br in w}
        frame = jgen.render(jp, jcfg, jr, key, film["geo"], film["app"],
                            batch_size=1, noise_std=0.0)["pixels"]
        seg = jnp.mean((frame[:, :-3] - gt18) ** 2)
        img = jnp.mean((frame[:, -3:] - gt_img) ** 2)
        norm = sum(jnp.mean(o ** 2) for br in offsets.values() for o in br)
        return lam["seg"] * seg + lam["img"] * img + lam["norm"] * norm

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(
        {br: tuple(jnp.asarray(x) for x in offsets[br]) for br in offsets})

    # the render's one draw: the stratified jitter of render_core's key
    k_rays = jax.random.split(key, 4)[0]
    k_perturb = jax.random.split(k_rays)[0]
    jitter = jax.random.uniform(k_perturb, (1, jr.n_rays, jr.num_steps))
    draws = tgen.RenderDraws(_t(jitter), None, None,
                             tgen.RayNoise(None, None, None))
    tr = tgen.RenderConfig(**render)
    tree = lambda d: {br: tuple(_t(x) for x in d[br]) for br in d}
    prob = tinv.Problem(
        tfields.with_grid_table(tp, tcfg, None), tcfg, tr, tree(w),
        _t(gt_img), _t(gt18), lam["seg"], lam["img"], 0.0, lam["norm"],
        None, {"geo": 1.0, "app": 1.0})
    (loss, _, _), grads = tinv.loss_and_grads(prob, tree(offsets),
                                              tree(noise), draws)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    for br in ("geo", "app"):
        for g, r in zip(grads[br], ref_grads[br]):
            r = np.asarray(r)
            assert np.abs(r).max() > 1e-4        # the render reaches W
            # rtol 1e-3, over an f32 floor for the entries that cancel
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-3, atol=1e-6)


def test_optimizer_matches_the_optax_chain():
    """Five updates from count 97 (the learning rate steps 1e-2 -> 7.5e-3
    between counts 99 and 100), weight decay before Adam, no clip."""
    rng = np.random.default_rng(6)
    shapes = {"geo": ((1, 32), (1, 32)), "app": ((1, 48), (1, 48))}
    normal = lambda s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)
    params = {br: tuple(normal(s, 0.1) for s in shapes[br]) for br in shapes}
    mu = {br: tuple(normal(s, 0.01) for s in shapes[br]) for br in shapes}
    nu = {br: tuple(np.abs(normal(s, 1e-3)) for s in shapes[br])
          for br in shapes}
    tx = optax.chain(
        optax.add_decayed_weights(1e-4), optax.scale_by_adam(),
        optax.scale_by_learning_rate(
            optax.exponential_decay(1e-2, 100, 0.75, staircase=True)))
    jparams = jax.tree.map(jnp.asarray, params)
    st = tx.init(jparams)
    st = (st[0], st[1]._replace(count=jnp.asarray(97, jnp.int32),
                                mu=jax.tree.map(jnp.asarray, mu),
                                nu=jax.tree.map(jnp.asarray, nu)),
          st[2]._replace(count=jnp.asarray(97, jnp.int32)))
    tree = lambda d: {br: tuple(_t(x) for x in d[br]) for br in d}
    tparams = tree(params)
    tstate = AdamState(97, tree(mu), tree(nu))
    for i in range(5):
        g = {br: tuple(normal(s) for s in shapes[br]) for br in shapes}
        if i == 2:      # a masked branch: zero gradient
            g["app"] = tuple(np.zeros(s, np.float32) for s in shapes["app"])
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tstate = tinv.OPTIMIZER.step(tparams, tree(g), tstate)
        assert tstate.count == int(st[1].count) == 98 + i
        for br in shapes:
            for a, b in zip(tparams[br], jparams[br]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=1e-6, rtol=0)
    assert tinv.OPTIMIZER.lr_at(99) == pytest.approx(1e-2)
    assert tinv.OPTIMIZER.lr_at(100) == pytest.approx(7.5e-3)


# ---------------------------------------------------------------------------
# LPIPS at stand-in weights
# ---------------------------------------------------------------------------

def _standin_lpips(rng):
    arrays, cin, idx = {}, 3, 0
    for si, (ch, n) in enumerate(jlpips._VGG_STAGES):
        for _ in range(n):
            arrays[f"conv{idx}_w"] = (rng.standard_normal((3, 3, cin, ch))
                                      * np.sqrt(2 / (9 * cin))
                                      ).astype(np.float32)
            arrays[f"conv{idx}_b"] = (rng.standard_normal(ch) * 0.01
                                      ).astype(np.float32)
            cin, idx = ch, idx + 1
        arrays[f"lin{si}_w"] = np.abs(
            rng.standard_normal((1, 1, ch, 1))).astype(np.float32)
    return arrays


def test_lpips_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    arrays = _standin_lpips(rng)
    x = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    ref = float(jax.jit(jlpips.lpips_distance)(
        jax.tree.map(jnp.asarray, arrays), jnp.asarray(x), jnp.asarray(y)))
    out = tlpips.lpips_distance(tlpips.torch_params(arrays), _t(x), _t(y))
    assert ref > 0
    np.testing.assert_allclose(out.item(), ref, rtol=1e-4)
    # the same .npz through both loaders
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **arrays)
    monkeypatch.setenv(tlpips.WEIGHTS_ENV, path)
    fn = tlpips.load_lpips(device="cpu")
    np.testing.assert_allclose(fn(_t(x), _t(y)).item(), ref, rtol=1e-4)
    monkeypatch.delenv(tlpips.WEIGHTS_ENV)
    assert tlpips.load_lpips(device="cpu") is None
