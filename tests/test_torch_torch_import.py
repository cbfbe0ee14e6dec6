"""The port's checkpoint importers (fenerf_tpu_torch/compat/torch_import.py,
nn/neural_renderer.py's and eval/lpips.py's converters) against the JAX
package's on the same seeded reference-layout state_dicts: bit-equal, leaf
for leaf, and equal to the trees the state_dicts were written from (the
stand-in writers of tests/torch_reference_standins.py invert the
importers). Every branch of the importers: res_sigma, color_pre_dim, the
single FiLM colour layer, label heads with and without label_film, single
and dual mapping, the texture grid, the modulated convs' three bias cases,
skip connections both ways, CoordConv and plain critic blocks."""
import dataclasses

import numpy as np
import pytest

import jax
import torch

import torch_reference_standins as st
from fenerf_tpu.compat import torch_import as jimp
from fenerf_tpu.eval import lpips as jlpips
from fenerf_tpu.nn import fields as jfields
from fenerf_tpu.nn import neural_renderer as jnr
from fenerf_tpu_torch.compat import torch_import as timp
from fenerf_tpu_torch.compat.jax_bridge import (from_numpy_tree,
                                                to_numpy_tree, tree_map)
from fenerf_tpu_torch.eval import lpips as tlpips
from fenerf_tpu_torch.nn import fields as tfields
from fenerf_tpu_torch.nn import latent_grid_field as tlgf
from fenerf_tpu_torch.nn import neural_renderer as tnr
from fenerf_tpu_torch.nn import stylegan as tsg

torch.set_num_threads(2)

FLAGSHIP = "TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96"
SMALL = dict(hidden_dim=16, z_geo_dim=8, z_app_dim=8, map_hidden_dim=16,
             grid_resolution=4, grid_channels=4)


def _seeded(tree, seed):
    """The tree's shapes, filled from a numpy seed."""
    rng = np.random.RandomState(seed)
    return tree_map(lambda t: torch.from_numpy(
        rng.standard_normal(tuple(t.shape)).astype(np.float32)), tree)


def _equal(jax_tree, port_tree, want=None):
    """JAX tree == port tree == want, bit for bit, structure included."""
    got = to_numpy_tree(port_tree)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), b, strict=True), jax_tree, got)
    if want is not None:
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            a, b, strict=True), to_numpy_tree(want), got)


FIELD_CASES = {
    # dual mapping, 3 FiLM colour layers, label head, texture grid
    "flagship": (FLAGSHIP, SMALL),
    # label head without grid
    "baseline_semantic": ("SIRENBASELINESEMANTICDISENTANGLE",
                          dict(hidden_dim=16, z_geo_dim=8, z_app_dim=8,
                               map_hidden_dim=16)),
    "res_sigma": ("RESSIRENDISENTANGLE",
                  dict(hidden_dim=16, z_geo_dim=8, z_app_dim=8,
                       map_hidden_dim=16)),
    "color_pre": ("SPATIALSIRENAUGDISENTANGLE",
                  dict(hidden_dim=16, z_geo_dim=8, z_app_dim=8,
                       map_hidden_dim=16)),
    # single latent, one FiLM colour layer (color_layer_sine.layer.*)
    "single_latent": ("SPATIALSIRENBASELINE",
                      dict(hidden_dim=16, z_geo_dim=8, z_app_dim=8,
                           map_hidden_dim=16)),
    # single latent, label_film
    "label_film": ("SPATIALSIRENSEMANTIC",
                   dict(hidden_dim=16, z_geo_dim=8, z_app_dim=8,
                        map_hidden_dim=16)),
    # single latent with a texture grid feeding the trunk
    "grid_trunk": ("EmbeddingPiGAN128",
                   dict(hidden_dim=16, z_geo_dim=8, z_app_dim=8,
                        map_hidden_dim=16, grid_resolution=4,
                        grid_channels=4)),
}


@pytest.mark.parametrize("case", sorted(FIELD_CASES))
def test_field_from_torch(case):
    name, kw = FIELD_CASES[case]
    tcfg = tfields.get_config(name, **kw)
    jcfg = jfields.get_config(name, **kw)
    params = _seeded(tfields.init_field(torch.Generator(), tcfg,
                                        device="meta"), seed=len(case))
    sd = st.field_state_dict(params, tcfg)
    _equal(jimp.field_from_torch(sd, jcfg), timp.field_from_torch(sd, tcfg),
           params)
    # numpy values and the generator pickles' 'siren.' prefix
    sd_np = {f"siren.{k}": v.numpy() for k, v in sd.items()}
    _equal(jimp.field_from_torch(sd_np, jcfg),
           timp.field_from_torch(sd_np, tcfg), params)


def test_field_single_colour_layer_as_a_list():
    """A one-layer colour branch stored as a ModuleList
    (color_layer_sine.0.layer.*) imports like the single FiLMLayer."""
    name, kw = FIELD_CASES["single_latent"]
    tcfg = tfields.get_config(name, **kw)
    params = _seeded(tfields.init_field(torch.Generator(), tcfg,
                                        device="meta"), seed=3)
    sd = st.field_state_dict(params, tcfg, single_film=False)
    assert "color_layer_sine.0.layer.weight" in sd
    _equal(jimp.field_from_torch(sd, jfields.get_config(name, **kw)),
           timp.field_from_torch(sd, tcfg), params)


def _style_params(skip_conn, seed):
    return _seeded(tsg.init_style_generator_2d(
        torch.Generator(), out_res=16, out_ch=4, z_dim=8, ch_max=8,
        skip_conn=skip_conn, device="meta"), seed)


@pytest.mark.parametrize("skip_conn", [False, True])
def test_style_generator_from_torch(skip_conn):
    params = _style_params(skip_conn, seed=11 + skip_conn)
    sd = st.style_generator_state_dict(params)
    # the three bias cases: .activate.bias (the styled convs), .bias as
    # (1, out, 1, 1) (to_rgb), neither (zeros)
    assert "conv1.activate.bias" in sd
    rgb = "to_rgb1.conv" if skip_conn else "out_rgb.conv"
    assert sd[f"{rgb}.bias"].shape == (1, 4, 1, 1)
    _equal(jimp.style_generator_from_torch(sd, skip_conn),
           timp.style_generator_from_torch(sd, skip_conn), params)
    del sd["convs.0.activate.bias"], sd[f"{rgb}.bias"]
    want = tree_map(lambda t: t, params)
    want["convs"][0]["b"] = torch.zeros_like(params["convs"][0]["b"])
    (want["to_rgb1"] if skip_conn else want["out_rgb"])["b"] = \
        torch.zeros_like(params["convs"][0]["b"][:4])
    _equal(jimp.style_generator_from_torch(sd, skip_conn),
           timp.style_generator_from_torch(sd, skip_conn), want)


def test_grid_field_from_torch():
    cfg = tlgf.get_grid_config("SPATIALSIRENGRID", z_dim=8, hidden_dim=16,
                               grid_res=16, grid_ch=4, ch_max=8,
                               map_hidden_dim=16)
    params = _seeded(tlgf.init_grid_field(torch.Generator(), cfg,
                                          device="meta"), seed=21)
    sd = {f"siren.{k}": v for k, v in st.grid_state_dict(params).items()}
    _equal(jimp.grid_field_from_torch(sd), timp.grid_field_from_torch(sd),
           params)


def _critic(n_blocks, seed):
    rng = np.random.RandomState(seed)
    conv = lambda i, o, k: {
        "w": torch.from_numpy(rng.standard_normal((k, k, i, o))
                              .astype(np.float32)),
        "b": torch.from_numpy(rng.standard_normal(o).astype(np.float32))}
    ch = [4, 6, 8, 8]
    return {"blocks": [{"conv1": conv(ch[i] + 2, ch[i + 1], 3),
                        "conv2": conv(ch[i + 1] + 2, ch[i + 1], 3),
                        "proj": conv(ch[i], ch[i + 1], 1)}
                       for i in range(n_blocks)],
            "from_rgb": [conv(3, c, 1) for c in ch],
            "final": conv(ch[n_blocks], 5, 2)}


@pytest.mark.parametrize("coord_conv", [True, False])
def test_discriminator_from_torch(coord_conv):
    params = _critic(3, seed=31 + coord_conv)
    sd = st.discriminator_state_dict(params, coord_conv)
    assert ("layers.0.network.0.conv.weight" in sd) == coord_conv
    _equal(jimp.discriminator_from_torch(sd, 3),
           timp.discriminator_from_torch(sd, 3), params)


NR_CASES = {
    "skip_bilinear": dict(n_feat=16, input_dim=16, out_dim=3, img_size=64,
                          input_size=16, min_feat=4),
    "conv_in_nn_norm": dict(n_feat=16, input_dim=8, out_dim=5,
                            final_actvn=False, img_size=32, input_size=16,
                            min_feat=8, upsample_rgb="nn", use_norm=True),
    "no_skip": dict(n_feat=8, input_dim=8, out_dim=3, img_size=64,
                    input_size=16, min_feat=2, use_rgb_skip=False,
                    upsample_feat="bilinear"),
}


@pytest.mark.parametrize("case", sorted(NR_CASES))
def test_neural_renderer_from_torch(case, tmp_path):
    kw = NR_CASES[case]
    root = st.write_tree(str(tmp_path / "ref"))
    with st.reference_modules(root) as (_, _, nr, _):
        torch.manual_seed(len(case))
        tm = nr.NeuralRenderer(**kw)
        tcfg = tnr.config_from_torch_module(tm)
        jcfg = jnr.config_from_torch_module(tm)
        sd = tm.state_dict()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.n_blocks == {"skip_bilinear": 2, "conv_in_nn_norm": 1,
                             "no_skip": 2}[case]
    sd_np = {k: v.numpy() for k, v in sd.items()}
    port = tnr.neural_renderer_from_torch(sd, tcfg)
    _equal(jnr.neural_renderer_from_torch(sd_np, jcfg), port)
    # the tree has the port's layout: the writer gives the state_dict back
    back = st.neural_renderer_state_dict(port)
    assert list(back) == list(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    # and the heads run on it
    x = torch.randn(1, tcfg.input_dim, 16, 16)
    y = tnr.apply_neural_renderer(port, tcfg, x)
    assert y.shape == (1, tcfg.out_dim, 16 * 2 ** tcfg.n_blocks,
                       16 * 2 ** tcfg.n_blocks)


class _Lpips(torch.nn.Module):
    """The lpips.LPIPS(net='vgg') state_dict layout, small widths: the VGG
    slices' convs by their global layer index, and the five linear heads."""

    def __init__(self):
        super().__init__()
        self.net = torch.nn.Module()
        widths = ((3, 4), (4, 4), (4, 6), (6, 6), (6, 8), (8, 8), (8, 8),
                  (8, 8), (8, 8), (8, 8), (8, 8), (8, 8), (8, 8))
        layer = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
        slices = (0, 0, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4)
        for s in range(5):
            self.net.add_module(f"slice{s + 1}", torch.nn.Module())
        for (i, o), li, s in zip(widths, layer, slices):
            getattr(self.net, f"slice{s + 1}").add_module(
                str(li), torch.nn.Conv2d(i, o, 3, padding=1))
        self.lins = torch.nn.ModuleList()
        for c in (4, 6, 8, 8, 8):
            head = torch.nn.Module()
            head.model = torch.nn.Sequential(
                torch.nn.Dropout(), torch.nn.Conv2d(c, 1, 1, bias=False))
            self.lins.append(head)


def test_convert_torch_lpips(tmp_path):
    torch.manual_seed(0)
    m = _Lpips()
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jlpips.convert_torch_lpips(m, jpath)
    tlpips.convert_torch_lpips(m, tpath)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert len(a.files) == 13 * 2 + 5
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], strict=True)
    # the port reads what it wrote: the distance runs and is 0 on equal
    # images
    fn = tlpips.load_lpips(tpath, device="cpu")
    x = torch.rand(1, 3, 32, 32) * 2 - 1
    assert float(fn(x, x)) == 0.0 and float(fn(x, -x)) > 0.0


def test_flagship_render_from_both_imports():
    """A tiny flagship field imported by either package renders the same
    image in the port, bit for bit."""
    tcfg = tfields.get_config(FLAGSHIP, **SMALL)
    params = tfields.init_field(torch.Generator().manual_seed(4), tcfg)
    params["sigma_head"]["b"] = params["sigma_head"]["b"] + 5.0
    sd = st.field_state_dict(params, tcfg)
    from_jax = from_numpy_tree(jax.tree.map(
        np.asarray, jimp.field_from_torch(sd, jfields.get_config(
            FLAGSHIP, **SMALL))))
    from fenerf_tpu_torch.models import generator as tgen

    rcfg = tgen.RenderConfig(img_size=8, num_steps=6, hierarchical=True)
    z = torch.randn((1, 8), generator=torch.Generator().manual_seed(1))
    out = []
    for p in (from_jax, timp.field_from_torch(sd, tcfg)):
        fg, fa = tfields.field_film(p, tcfg, z, z)
        with torch.no_grad():
            out.append(tgen.render(
                p, tcfg, rcfg, fg, fa, 1,
                generator=torch.Generator().manual_seed(2))["pixels"])
    assert torch.isfinite(out[0]).all() and out[0].abs().max() > 0
    assert torch.equal(out[0], out[1])
