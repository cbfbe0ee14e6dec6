"""The port's checkpoint converter CLI (fenerf_tpu_torch/apps/
convert_checkpoint.py) against the JAX package's (fenerf_tpu/apps/
convert_checkpoint.py) on the same whole-module pickles of the stand-in
reference tree (tests/torch_reference_standins.py, given to both as
--reference): the two .npz files have the same __config__ and bit-equal
leaves, and the port's leaves are the trees the pickles were written from.
Each CLI runs in a subprocess of its own (both put --reference on sys.path
and register modules), once for all the cases.

Cases: the flagship with ema.pth and ema2.pth (--model auto); the flagship
with no EMA files (both fall back to the params; --model named); a
semantic baseline whose output width re-derives n_labels, with ema.pth but
no ema2.pth; SPATIALSIRENGRID (auto); an HD variant with its
neural-renderer heads (auto)."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import torch

import torch_reference_standins as st
from fenerf_tpu_torch.apps.common import load_generator, load_neural_renderers
from fenerf_tpu_torch.compat.jax_bridge import to_numpy_tree, tree_leaves
from fenerf_tpu_torch.nn import fields as tfields
from fenerf_tpu_torch.nn import latent_grid_field as tlgf
from fenerf_tpu_torch.nn import neural_renderer as tnr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = "TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96"
SMALL = dict(hidden_dim=16, z_geo_dim=8, z_app_dim=8, map_hidden_dim=16,
             grid_resolution=4, grid_channels=4)
PACKAGES = ("fenerf_tpu", "fenerf_tpu_torch")


def _scaled(sd, f):
    return {k: v * f for k, v in sd.items()}


def _film_case(root, d, name, kw, seed, ema, ema2, wrapper, heads=None,
               step=0):
    cfg = tfields.get_config(name, **kw)
    params = tfields.init_field(torch.Generator().manual_seed(seed), cfg)
    sd = st.field_state_dict(params, cfg)
    e1 = _scaled(sd, 1.01) if ema else None
    e2 = _scaled(sd, 0.99) if ema2 else None
    path = st.write_generator(root, d, name, sd, st.field_attrs(cfg), step,
                              ema=e1, ema2=e2, heads=heads, wrapper=wrapper)
    return path, (sd, e1 or sd, e2 or sd)


def _cases(root, tmp):
    """-> {case: (argv tail, (params, ema, ema2) state_dicts, heads)}."""
    cases = {}
    d = lambda c: os.path.join(tmp, c)
    path, sds = _film_case(root, d("film_ema"), FLAGSHIP, SMALL, 0, True,
                           True, "DoubleImplicitGenerator3d", step=120)
    cases["film_ema"] = (["--generator", path, "--model", "auto"], sds, {})
    path, sds = _film_case(root, d("film_no_ema"), FLAGSHIP, SMALL, 1, False,
                           False, "DoubleImplicitGenerator3d")
    cases["film_no_ema"] = (["--generator", path, "--model", FLAGSHIP], sds,
                            {})
    # 19 labels where the registry has 18: output width 23 -> n_labels 19
    kw = dict(hidden_dim=16, z_geo_dim=8, z_app_dim=8, map_hidden_dim=16,
              n_labels=19)
    path, sds = _film_case(root, d("n_labels"),
                           "SIRENBASELINESEMANTICDISENTANGLE", kw, 2, True,
                           False, "DoubleImplicitGenerator3d")
    cases["n_labels"] = (["--generator", path], sds, {})

    # the published plane resolution (the checkpoint's tree has one conv
    # pair per doubling), narrow channels
    gcfg = tlgf.get_grid_config("SPATIALSIRENGRID", z_dim=8, hidden_dim=16,
                                grid_ch=4, ch_max=8, map_hidden_dim=16)
    gp = tlgf.init_grid_field(torch.Generator().manual_seed(3), gcfg)
    sd = st.grid_state_dict(gp)
    e1, e2 = _scaled(sd, 1.01), _scaled(sd, 0.99)
    path = st.write_generator(root, d("grid"), "SPATIALSIRENGRID", sd,
                              st.field_attrs(gcfg), 55, ema=e1, ema2=e2,
                              wrapper="ImplicitGenerator3d")
    cases["grid"] = (["--generator", path, "--model", "auto"],
                     (sd, e1, e2), {})

    heads = {}
    for key, out_dim, act, seed in (("nr_img", 3, True, 4),
                                    ("nr_seg", 19, False, 5)):
        ncfg = tnr.NeuralRendererConfig(n_feat=16, input_dim=16,
                                        out_dim=out_dim, final_actvn=act,
                                        min_feat=4, img_size=64,
                                        input_size=16)
        hp = tnr.init_neural_renderer(torch.Generator().manual_seed(seed),
                                      ncfg)
        heads[key] = (st.neural_renderer_state_dict(hp),
                      dataclasses.asdict(ncfg))
    kw = dict(hidden_dim=16, z_geo_dim=8, z_app_dim=8, map_hidden_dim=16)
    path, sds = _film_case(root, d("hd"), "SPATIALSIRENSEMANTICHD", kw, 6,
                           True, True, "StyleGenerator3d", heads=heads)
    cases["hd"] = (["--generator", path], sds, heads)
    return cases


def _run_cli(package, runs):
    """Every conversion of `runs` ([argv, ...]) in one subprocess of the
    package's CLI."""
    code = ("import json, sys\n"
            f"from {package}.apps.convert_checkpoint import main\n"
            "for argv in json.loads(sys.argv[1]):\n"
            "    main(argv)\n")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    r = subprocess.run([sys.executable, "-c", code, json.dumps(runs)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return r.stdout


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("convert"))
    try:
        root = st.write_tree(os.path.join(tmp, "reference"))
        cases = _cases(root, tmp)
        out = {}
        for package in PACKAGES:
            runs = []
            for case, (argv, _, _) in cases.items():
                npz = os.path.join(tmp, f"{case}_{package}.npz")
                runs.append(argv + ["--out", npz, "--reference", root])
                out[case, package] = npz
            stdout = _run_cli(package, runs)
            assert stdout.count("converted ") == len(cases), stdout
        yield cases, out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)   # pickles of every case


CASES = ("film_ema", "film_no_ema", "n_labels", "grid", "hd")


@pytest.mark.parametrize("case", CASES)
def test_port_cli_is_the_jax_cli(converted, case):
    _, out = converted
    with np.load(out[case, "fenerf_tpu"]) as a, \
            np.load(out[case, "fenerf_tpu_torch"]) as b:
        assert json.loads(str(a["__config__"])) == \
            json.loads(str(b["__config__"]))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], strict=True)


@pytest.mark.parametrize("case", CASES)
def test_port_cli_leaves_are_the_written_trees(converted, case):
    """The converted params / ema / ema2 are the state_dicts the pickles
    were written from (a missing EMA file falls back to the params), and
    the checkpoint loads in the port."""
    cases, out = converted
    _, sds, heads = cases[case]
    params, ema, ema2, cfg, config = load_generator(
        out[case, "fenerf_tpu_torch"], device="cpu")
    want_sd = st.grid_state_dict if case == "grid" else (
        lambda p: st.field_state_dict(p, cfg))
    for tree, sd in zip((params, ema, ema2), sds):
        got = want_sd(tree)
        assert list(got) == list(sd)
        for k in sd:
            assert torch.equal(got[k], sd[k]), k
    expect = {"film_ema": (FLAGSHIP, 120), "film_no_ema": (FLAGSHIP, 0),
              "n_labels": ("SIRENBASELINESEMANTICDISENTANGLE", 0),
              "grid": ("SPATIALSIRENGRID", 55),
              "hd": ("SPATIALSIRENSEMANTICHD", 0)}[case]
    assert (config["model"], config["step"]) == expect
    if case == "n_labels":
        assert config["field_kwargs"]["n_labels"] == 19
        assert cfg.output_dim == 23
    if case == "grid":
        assert config["family"] == "grid" and cfg.z_dim == 8
    nrs = load_neural_renderers(out[case, "fenerf_tpu_torch"], device="cpu")
    assert sorted(nrs) == sorted(heads)
    for key, (sd, kw) in heads.items():
        p, ncfg = nrs[key]
        assert ncfg.n_blocks == 2 and ncfg.out_dim == kw["out_dim"]
        back = st.neural_renderer_state_dict(p)
        assert [torch.equal(back[k], sd[k]) for k in sd] == [True] * len(sd)
    assert len(tree_leaves(to_numpy_tree(params))) == config["n_params"]
