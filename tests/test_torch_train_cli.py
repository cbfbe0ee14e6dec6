"""The trainer's entry point on the CPU and its checkpoints: train-state
.npz files between fenerf_tpu.utils.checkpoint and the port both ways,
leaf for leaf; `python -m fenerf_tpu_torch.apps.train` at tiny widths on a
synthetic CelebAMask-HQ tree (metrics, generator checkpoint that renders,
sample grids, FID on stand-in InceptionV3 weights); a resumed run equal to
the straight run leaf for leaf; the latent-grid family's smoke_grid on the
committed JPEGs; the refusals (multi-process, CUDA absent); and
chip_smoke.py's stop of the processes the loader leaves.
"""
import importlib.util
import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from fenerf_tpu.train import curriculum as jcur
from fenerf_tpu.train import loop as jloop
from fenerf_tpu.utils import checkpoint as jckpt
from fenerf_tpu_torch.apps import train as tcli
from fenerf_tpu_torch.apps.common import load_generator
from fenerf_tpu_torch.compat.jax_bridge import tree_leaves
from fenerf_tpu_torch.data import celeba_mask as tdata
from fenerf_tpu_torch.data import synthetic
from fenerf_tpu_torch.data.synthetic import write_celebamask_tree
from fenerf_tpu_torch.models import generator as tgen
from fenerf_tpu_torch.nn import inception
from fenerf_tpu_torch.train import curriculum as tcur
from fenerf_tpu_torch.train import loop as tloop
from fenerf_tpu_torch.utils import checkpoint as tckpt
from fenerf_tpu_torch.utils.image import read_png

from test_torch_train_step import _jax_moments, tiny_texture_meta

torch.set_num_threads(2)

TEXTURE = "CelebA_double_semantic_texture_embedding_256_dim_96"


def perturbed(state):
    """A JAX TrainState whose every leaf differs from `state`'s (moments,
    counts, EMA counters, step): floats by a normal draw, integers by 3;
    Adam's second moments kept >= 0, so that the state can step."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(state)
    rng = np.random.default_rng(0)
    out = []
    for path, x in leaves:
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            x = x + rng.standard_normal(x.shape, dtype=np.float32)
            if any(getattr(k, "name", None) == "nu" for k in path):
                x = np.abs(x)
        else:
            x = x + 3
        out.append(jnp.asarray(x))
    return jax.tree_util.tree_unflatten(treedef, out)


def _perturbed_jax_state(meta):
    """The JAX package's initial TrainState, perturbed."""
    return perturbed(jloop.init_train_state(jax.random.key(0), meta))


@pytest.mark.parametrize("unique_lr", [True, False])
def test_checkpoint_from_jax(tmp_path, unique_lr):
    jmeta = tiny_texture_meta(jcur, unique_lr=unique_lr)
    tmeta = tiny_texture_meta(tcur, unique_lr=unique_lr)
    jst = _perturbed_jax_state(jmeta)
    path = str(tmp_path / "train_state.npz")
    jckpt.save(path, jst)
    tst = tckpt.load(path, tloop.init_train_state(tmeta, device="cpu"))
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jst)]
    tleaves = tckpt.state_leaves(tst)
    assert len(jleaves) == len(tleaves)
    for i, (a, b) in enumerate(zip(jleaves, tleaves)):
        assert a.shape == b.shape, i
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=str(i))
    # by meaning, not only by position
    assert tst.step == int(jst.step) and tst.opt_g.count == 3
    assert tst.ema.num_updates == int(jst.ema.num_updates)
    jmu = _jax_moments(jst.opt_g, unique_lr)
    for key in tst.opt_g.mu:
        for a, b in zip(jax.tree.leaves(jmu[key]),
                        tree_leaves(tst.opt_g.mu[key])):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jax.tree.leaves(jst.d_seg_params),
                    tree_leaves(tst.d_seg_params)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_checkpoint_to_jax(tmp_path):
    jmeta, tmeta = tiny_texture_meta(jcur), tiny_texture_meta(tcur)
    tst = tloop.init_train_state(tmeta, seed=3, device="cpu")
    g = torch.Generator().manual_seed(1)
    for name in ("opt_g", "opt_img", "opt_seg"):
        for t in tree_leaves(getattr(tst, name).mu):
            t.add_(torch.randn(t.shape, generator=g))
    tst = tst._replace(step=7, opt_g=tst.opt_g._replace(count=7))
    path = str(tmp_path / "train_state.npz")
    tckpt.save(path, tst)
    jst = jckpt.load(path, jloop.init_train_state(jax.random.key(0), jmeta))
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(jst),
                                   tckpt.state_leaves(tst))):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(i))
    assert int(jst.step) == 7
    # the port's own round trip
    again = tckpt.load(path, tloop.init_train_state(tmeta, device="cpu"))
    for a, b in zip(tckpt.state_leaves(again), tckpt.state_leaves(tst)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

TINY = ["--field_overrides",
        '{"hidden_dim": 16, "map_hidden_dim": 16, "grid_resolution": 8, '
        '"grid_channels": 8}',
        "--stage_overrides",
        '{"batch_size": 4, "batch_split": 2, "img_size": 16, "num_steps": 4, '
        '"latent_geo_dim": 8, "latent_app_dim": 8, "target_size": 16}']


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """8 pairs: 4 small JPEGs (written by PIL) in turn, label PNGs written
    by the port."""
    d = tmp_path_factory.mktemp("celeba")
    rng = np.random.default_rng(0)
    jpgs = []
    for i in range(4):
        p = str(d / f"src{i}.jpg")
        Image.fromarray(rng.integers(0, 255, (48, 40, 3), dtype=np.uint8)
                        ).save(p, quality=90)
        jpgs.append(p)
    return write_celebamask_tree(str(d / "data"), jpgs, count=8, seed=1,
                                 mask_size=24)


def _run(data_root, out, *extra):
    return tcli.main(["--curriculum", TEXTURE, "--data_root", data_root,
                      "--device", "cpu", "--log_every", "1",
                      "--output_dir", str(out)] + TINY + list(extra))


def test_cli_trains_samples_checkpoints_and_scores(data_root, tmp_path,
                                                   monkeypatch):
    weights = str(tmp_path / "inception.npz")
    inception.export_npz(
        inception.init_inception(torch.Generator().manual_seed(0)), weights)
    monkeypatch.setenv("FENERF_INCEPTION_WEIGHTS", weights)
    out = tmp_path / "run"
    _run(data_root, out, "--total_steps", "3", "--model_save_interval", "2",
         "--sample_interval", "2", "--eval_freq", "3", "--num_eval_imgs", "4",
         "--num_real_imgs", "4")
    lines = [json.loads(x) for x in
             (out / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 1, 2]
    for x in lines:
        for k in ("d_img_loss", "d_seg_loss", "g_loss", "imgs_per_sec",
                  "step_ms", "loader_ms"):
            assert math.isfinite(x[k]), k
    for tag in ("fixed", "tilted", "fixed_ema", "tilted_ema", "random_ema"):
        for kind in ("img", "seg"):
            img = read_png(str(out / f"2_{kind}_{tag}.png"))
            assert img.shape == (2 + 5 * 18, 2 + 5 * 18, 3)
    fid = float((out / "fid.txt").read_text().strip().split(":")[1])
    assert math.isfinite(fid)
    assert len(os.listdir(out / "evaluation" / "real")) == 4
    assert len(os.listdir(out / "evaluation" / "generated")) == 4
    params, ema, _, cfg, config = load_generator(str(out / "generator.npz"),
                                                 device="cpu")
    assert config["step"] == 2 and cfg.hidden_dim == 16
    rcfg = tgen.RenderConfig(img_size=8, num_steps=4)
    z = torch.randn(1, 8, generator=torch.Generator().manual_seed(0))
    pix = tgen.render_any(ema, cfg, rcfg, z, z)["pixels"]
    assert pix.shape == (1, 21, 8, 8) and torch.isfinite(pix).all()
    assert (out / "train_state.npz").exists()
    assert (out / "stats.json").exists() and (out / "options.txt").exists()


def test_cli_grad_rays_and_diff_augment(data_root, tmp_path):
    """--grad_rays and a DiffAugment policy (a stage override) reach the
    step through the CLI."""
    stage = json.loads(TINY[3])
    stage["diff_augment_policy"] = "color,translation,cutout"
    out = tmp_path / "aug"
    state = tcli.main(["--curriculum", TEXTURE, "--data_root", data_root,
                       "--device", "cpu", "--log_every", "1",
                       "--output_dir", str(out), "--total_steps", "2",
                       "--model_save_interval", "0", "--sample_interval",
                       "0", "--eval_freq", "0", "--grad_rays", "0.5",
                       TINY[0], TINY[1], "--stage_overrides",
                       json.dumps(stage)])
    assert int(state.step) == 2
    lines = [json.loads(x) for x in
             (out / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 1]
    assert all(math.isfinite(x[k]) for x in lines
               for k in ("d_img_loss", "d_seg_loss", "g_loss"))
    options = (out / "options.txt").read_text()
    assert "grad_rays=0.5" in options
    assert "diff_augment_policy='color,translation,cutout'" in options


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms: the CPU scatter-add of the
    texture gather's backward otherwise sums in a varying order (the grid
    gradient differs by an ulp from run to run)."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def test_cli_resume_equals_straight_run(data_root, tmp_path, capsys,
                                        deterministic):
    args = ("--model_save_interval", "0", "--sample_interval", "0",
            "--eval_freq", "0")
    _run(data_root, tmp_path / "a", "--total_steps", "2", *args)
    _run(data_root, tmp_path / "b", "--total_steps", "3", "--load_dir",
         str(tmp_path / "a"), *args)
    assert "at step 2" in capsys.readouterr().out
    _run(data_root, tmp_path / "c", "--total_steps", "3", *args)
    with np.load(tmp_path / "b" / "train_state.npz") as b, \
            np.load(tmp_path / "c" / "train_state.npz") as c:
        assert sorted(b.files) == sorted(c.files)
        for k in b.files:
            if k != "__manifest__":
                np.testing.assert_array_equal(b[k], c[k], err_msg=k)


def test_cli_smoke_grid(tmp_path, capsys, deterministic):
    """The latent-grid family through the CLI on the committed JPEGs (a
    CelebA jpg glob): finite losses, RGB sample sheets only, a grid
    generator.npz that both packages open and render alike, and a resume
    from train_state.npz equal to the straight run leaf for leaf."""
    from fenerf_tpu.apps.common import load_generator as jload_generator
    from fenerf_tpu.models import generator as jgen

    base = ["--curriculum", "smoke_grid", "--device", "cpu",
            "--data_root", str(synthetic.FIXTURES / "*.jpg"),
            "--log_every", "1", "--eval_freq", "0",
            "--stage_overrides", '{"target_size": 16}']
    a, b, c = (tmp_path / d for d in "abc")
    tcli.main(base + ["--output_dir", str(a), "--total_steps", "2",
                      "--model_save_interval", "2", "--sample_interval",
                      "2"])
    assert "field torch, rays torch" in capsys.readouterr().out
    lines = [json.loads(x) for x in
             (a / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 1]
    for x in lines:
        for k in ("d_img_loss", "g_loss", "imgs_per_sec", "step_ms"):
            assert math.isfinite(x[k]), k
        assert x["d_seg_loss"] == 0.0
    for tag in ("fixed", "tilted", "fixed_ema", "tilted_ema", "random_ema"):
        img = read_png(str(a / f"2_img_{tag}.png"))
        assert img.shape == (2 + 5 * 18, 2 + 5 * 18, 3)
    assert not list(a.glob("*_seg_*"))

    path = str(a / "generator.npz")
    _, ema, _, cfg, config = load_generator(path, device="cpu")
    _, jema, _, jcfg, jconfig = jload_generator(path)
    assert config["family"] == jconfig["family"] == "grid"
    assert config["step"] == 2 and cfg == tgen.get_any_config(
        "SPATIALSIRENGRID", **jconfig["field_kwargs"])
    assert cfg.z_dim == 16 and cfg.hidden_dim == jcfg.hidden_dim == 32
    # a render without draws: no jitter, one pass, the mean camera
    rcfg = tgen.RenderConfig(img_size=8, num_steps=4, perturb=False,
                             hierarchical=False, sample_dist=None)
    z = np.random.default_rng(0).standard_normal((1, 16)).astype(np.float32)
    pix = tgen.render_any(ema, cfg, rcfg, torch.from_numpy(z),
                          torch.from_numpy(z))["pixels"]
    ref = jgen.render_grid_from_z(jema, jcfg, jgen.RenderConfig(
        img_size=8, num_steps=4, perturb=False, hierarchical=False,
        sample_dist=None), jax.random.key(0), jnp.asarray(z))["pixels"]
    assert pix.shape == (1, 3, 8, 8)
    np.testing.assert_allclose(pix.numpy(), np.asarray(ref), atol=1e-4)

    tcli.main(base + ["--output_dir", str(b), "--total_steps", "3",
                      "--load_dir", str(a), "--model_save_interval", "0",
                      "--sample_interval", "0"])
    assert "at step 2" in capsys.readouterr().out
    tcli.main(base + ["--output_dir", str(c), "--total_steps", "3",
                      "--model_save_interval", "0", "--sample_interval",
                      "0"])
    with np.load(b / "train_state.npz") as x, \
            np.load(c / "train_state.npz") as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            if k != "__manifest__":
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("extra,exc,match", [
    (["--multihost"], NotImplementedError, "ROADMAP A4"),
    (["--num_processes", "2"], NotImplementedError, "ROADMAP A4"),
])
def test_cli_refusals(data_root, tmp_path, extra, exc, match):
    with pytest.raises(exc, match=match):
        _run(data_root, tmp_path / "x", "--total_steps", "1", *extra)


def test_cli_needs_cuda_unless_cpu(data_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--curriculum", TEXTURE, "--data_root", data_root,
                   "--output_dir", str(tmp_path / "y")])


def test_smoke_script_leaves_no_process(data_root):
    """The loader's fork server and the resource tracker outlive a script
    for a while after it exits; chip_smoke.py stops them, and any other
    child, waiting for each, before it prints its result."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ds = tdata.make_dataset("CelebAMaskHQ_wo_background_seg_18", data_root,
                            16)
    batches = tdata.iterate_batches(ds, 2)
    assert next(batches)[0].shape == (2, 3, 16, 16)
    batches.close()
    assert smoke._children(os.getpid())   # the fork server at least
    smoke.stop_helper_processes()
    assert smoke._children(os.getpid()) == []
