"""The field kernels' device layouts (fenerf_tpu_torch/ops/film_mlp.py::pack,
ops/film_mlp_grad.py::pack_bwd), checked on the CPU without the card: the
swizzled weight chunks that ops/csrc/film_mlp.cu and film_mlp_bwd.cu copy
with one bulk copy each give back the flat padded weights bit for bit, and
the backward's [region][row][width] scratch regions cover every layer's x,
dy and y exactly once.

The un-swizzle here is written from the wgmma layout (128-byte rows of 64
K values, 16-byte group q of row r at position q ^ (r % 8)), not from the
packs' gather index.
"""
import numpy as np
import pytest
import torch

from fenerf_tpu_torch.nn import fields
from fenerf_tpu_torch.ops import film_mlp as fops
from fenerf_tpu_torch.ops import film_mlp_grad as gops

FLAGSHIP = "TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96"
FORWARD = [(FLAGSHIP, dict(grid_resolution=8)),
           ("TextureEmbeddingPiGAN128SEMANTICDISENTANGLE",
            dict(grid_resolution=8)),                      # hidden 128
           ("SPATIALSIRENSEMANTICHD", {})]                 # 64-wide heads
BACKWARD = [(FLAGSHIP, dict(grid_resolution=8)),
            ("TextureEmbeddingPiGAN128SEMANTICDISENTANGLE",
             dict(grid_resolution=8)),                     # hidden 128
            ("SPATIALSIRENBASELINEHD", {})]                # 64-wide rgb


def _params(name, kw):
    cfg = fields.get_config(name, **kw)
    gen = torch.Generator().manual_seed(0)
    return cfg, fields.init_field(gen, cfg)


def _unswizzle(wdev: np.ndarray, k_total, n_pad, nd, dev_off) -> np.ndarray:
    """The (k_total, n_pad) block of one layer from its device layout, and
    assert that every position past the block holds zero."""
    np_ = min(nd, 128)
    kch = -(-k_total // 64)
    out = np.zeros((kch * 64, nd), dtype=wdev.dtype)
    r = np.arange(np_)[:, None]
    q = np.arange(64)[None, :]
    k_in_chunk = (((q >> 3) ^ (r & 7)) << 3) + (q & 7)
    for p in range(nd // np_):
        for c in range(kch):
            base = dev_off + (p * kch + c) * np_ * 64
            chunk = wdev[base:base + np_ * 64].reshape(np_, 64)
            out[c * 64 + k_in_chunk, p * np_ + r] = chunk
    assert not out[k_total:].any() and not out[:, n_pad:].any()
    return out[:k_total, :n_pad]


def _check_layout(weights, wdev, steps):
    """steps: (k_total, n_pad, n_dev, w_off, dev_off) per layer / step."""
    flat = weights.view(torch.int16).numpy()
    dev = wdev.view(torch.int16).numpy()
    size = 0
    for k_total, n_pad, nd, w_off, dev_off in steps:
        assert nd in (16, 32, 64, 128, 256) and nd >= n_pad
        assert dev_off == size and (dev_off * 2) % 1024 == 0
        block = flat[w_off:w_off + k_total * n_pad].reshape(k_total, n_pad)
        np.testing.assert_array_equal(
            _unswizzle(dev, k_total, n_pad, nd, dev_off), block)
        size += -(-k_total // 64) * 64 * nd
    assert size == dev.size


@pytest.mark.parametrize("name,kw", FORWARD)
def test_forward_device_layout_unswizzles_to_flat_weights(name, kw):
    cfg, params = _params(name, kw)
    pack = fops.pack(params, cfg)
    prog = pack.program.tolist()
    _check_layout(pack.weights, pack.wdev,
                  [(d[23], d[10], d[24], d[11], d[25]) for d in prog])
    for d in prog:
        np_ = min(d[24], 128)
        assert d[26] == -(-d[23] // 64) * (d[24] // np_)   # chunks copied
    assert pack.max_n_dev == max(d[24] for d in prog)


@pytest.mark.parametrize("name,kw", BACKWARD)
def test_backward_device_layout_unswizzles_to_flat_weights(name, kw):
    cfg, params = _params(name, kw)
    pack = gops.pack_bwd(params, cfg)
    hd = pack.head
    prog = pack.program.tolist()
    steps = [prog[gops.HEAD_INTS + i * gops.STEP_INTS:
                  gops.HEAD_INTS + (i + 1) * gops.STEP_INTS]
             for i in range(hd["n_fwd"] + hd["n_bwd"])]
    _check_layout(pack.weights, pack.wdev,
                  [(d[25], d[10], d[26], d[11], d[27]) for d in steps])


def _claim(used: np.ndarray, co: int, w: int, what: str):
    assert co >= 0 and co + w <= used.size, (what, co, w, used.size)
    assert not used[co:co + w].any(), f"{what} overlaps another region"
    used[co:co + w] = True


@pytest.mark.parametrize("name,kw", BACKWARD)
def test_backward_scratch_regions_cover_each_layer_once(name, kw):
    cfg, params = _params(name, kw)
    pack = gops.pack_bwd(params, cfg)
    hd = pack.head
    prog = pack.program.tolist()
    steps = [prog[gops.HEAD_INTS + i * gops.STEP_INTS:
                  gops.HEAD_INTS + (i + 1) * gops.STEP_INTS]
             for i in range(hd["n_fwd"] + hd["n_bwd"])]
    x_used = np.zeros(hd["dev_x_w"], bool)
    dy_used = np.zeros(hd["dev_dy_w"], bool)
    y_used = np.zeros(hd["dev_y_w"], bool)
    # x: the two input regions and one per layer output of the recompute
    _claim(x_used, hd["dev_pts_x"], 64, "points x")
    _claim(x_used, hd["dev_dg_x"], hd["dev_dg_w"], "dirs / grid x")
    film_layers = cfg.trunk_layers + cfg.color_layers
    n_y = 0
    for d in steps:
        kind, n_pad, y_dev, y_w, out, out_w = (d[13], d[10], d[29], d[30],
                                               d[31], d[32])
        if kind in (gops.E_FILM_FWD, gops.E_PRE):
            assert y_w == n_pad
            _claim(y_used, y_dev, y_w, f"y of step {steps.index(d)}")
            n_y += 1
        if kind in (gops.E_FILM_FWD, gops.E_LIN_FWD):
            assert out_w % 64 == 0 and out % 64 == 0 and out_w >= n_pad
            _claim(x_used, out, out_w, f"x of step {steps.index(d)}")
        if kind in (gops.E_FILM_BWD, gops.E_LIN_BWD):
            assert out_w % 64 == 0 and out % 64 == 0 and out_w >= n_pad
            _claim(dy_used, out, out_w, f"dy of step {steps.index(d)}")
    # the heads' dy come from the seed
    _claim(dy_used, hd["dev_sig_dy"], 64, "sigma dy")
    _claim(dy_used, hd["dev_rgb_dy"], hd["dev_rgb_dy_w"], "rgb dy")
    if cfg.n_labels:
        _claim(dy_used, hd["dev_lbl_dy"], hd["dev_lbl_dy_w"], "label dy")
    assert n_y == film_layers + int(bool(cfg.n_labels and cfg.label_sigmoid)) \
        + int(cfg.rgb_sigmoid)
    assert x_used.all() and dy_used.all()
    assert y_used[:sum(d[30] for d in steps
                       if d[13] in (gops.E_FILM_FWD, gops.E_PRE))].all()
    # every linear's dy region once, and its dW rows from the x regions
    # exactly once
    tiles = pack.dw_tiles.tolist()
    for lay in pack.layers:
        items = [t for t in tiles if t[5] == lay["dw"]]
        assert len({t[3] for t in items}) == 1
        rows = np.zeros(lay["k"], int)
        for t in items:
            assert t[8] == lay["n"] and t[2] % 64 == 0 and t[7] <= 64
            assert x_used[t[0]:t[0] + t[1]].all()
            rows[t[6]:t[6] + t[7]] += 1
        assert (rows == 1).all()


def test_packs_reuse_the_plan_per_configuration():
    cfg, params = _params(FLAGSHIP, dict(grid_resolution=8))
    a, b = fops.pack(params, cfg), fops.pack(params, cfg)
    assert a.program is b.program and torch.equal(a.wdev, b.wdev)
    ga, gb = gops.pack_bwd(params, cfg), gops.pack_bwd(params, cfg)
    assert ga.program is gb.program and ga.dw_tiles is gb.dw_tiles
    assert torch.equal(ga.wdev, gb.wdev)
    # new weight values go through the same plan
    params["trunk"][1]["w"] = params["trunk"][1]["w"] * 2
    c = fops.pack(params, cfg)
    assert c.program is a.program and not torch.equal(c.wdev, a.wdev)
