"""Port parity for the latent-grid family's training (SPATIALSIRENGRID,
the smoke_grid / CelebA_latent_grid curricula): the gradients of the
StyleGAN2 resampling ops, the modulated convolution and StyleGenerator2D,
of grid_sample_2d's plane and of the grid field per parameter group, each
against jax.vjp (jitted) on numpy-seeded inputs; the convolutions'
backward under exact_convs(); one whole train_step against
fenerf_tpu.train.loop.train_step on the JAX step's own draws, at
batch_split 1 and 2; the updates reach every part of G; and a JAX grid
train_state.npz through the port and back. smoke_grid's widths: hidden 32,
a plane of 8 x 8^2, ch_max 16, z 16.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fenerf_tpu.core.grid_sample import grid_sample_2d as jgs2d
from fenerf_tpu.nn import latent_grid_field as jlgf
from fenerf_tpu.nn import stylegan as jsg
from fenerf_tpu.ops import upfirdn2d as jup
from fenerf_tpu.train import curriculum as jcur
from fenerf_tpu.train import ema as jema
from fenerf_tpu.train import loop as jloop
from fenerf_tpu.utils import checkpoint as jckpt
from fenerf_tpu_torch.compat import jax_bridge
from fenerf_tpu_torch.compat.jax_bridge import tree_leaves
from fenerf_tpu_torch.core.grid_sample import grid_sample_2d as tgs2d
from fenerf_tpu_torch.nn import latent_grid_field as tlgf
from fenerf_tpu_torch.nn import stylegan as tsg
from fenerf_tpu_torch.ops import upfirdn2d as tup
from fenerf_tpu_torch.train import curriculum as tcur
from fenerf_tpu_torch.train import loop as tloop
from fenerf_tpu_torch.utils import checkpoint as tckpt

from test_torch_train_cli import perturbed
from test_torch_train_step import (_jax_moments, assert_grads_match,
                                   jax_step_draws)

torch.set_num_threads(2)

SMOKE = "smoke_grid"
# f32 on both sides, the sums in XLA's and torch's orders: relative to
# each leaf's largest gradient
GRAD_RTOL = 1e-4
# two f32 roundings of a parameter, relative to its value
F32_ROUND = 2.0 ** -22


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _smoke_meta(cur, **overrides):
    return dataclasses.replace(cur.CURRICULA[SMOKE].at_step(0), **overrides)


def _jax_state(jmeta, tstate):
    """The JAX package's step-0 TrainState (fenerf_tpu/train/loop.py::
    init_train_state's) around the three networks of a port state: the
    same layout without the JAX initializers' one compile per shape."""
    nets = {k: jax.tree.map(jnp.asarray, v) for k, v in
            jax_bridge.train_params_to_numpy(tstate).items()}
    g, d_img, d_seg = (nets[k] for k in jax_bridge.TRAIN_PARAMS)
    return jloop.TrainState(
        g_params=g, d_img_params=d_img, d_seg_params=d_seg,
        opt_g=jloop.make_g_optimizer(jmeta, g).init(g),
        opt_img=jloop.make_d_optimizer(jmeta, "img").init(d_img),
        opt_seg=jloop.make_d_optimizer(jmeta, "seg").init(d_seg),
        ema=jema.ema_init(g, 0.999), ema2=jema.ema_init(g, 0.9999),
        step=jnp.asarray(0, jnp.int32))


def _vjps(jf, tf, inputs, seed=5):
    """d<f(inputs), ct>/d inputs for a random cotangent ct, by jax.vjp
    (jitted) and by torch's autograd. `inputs` is a numpy tree; returns
    the two gradient leaf lists (jax.tree_util order)."""
    jin = jax.tree.map(jnp.asarray, inputs)
    out_shape = jax.eval_shape(jf, jin).shape
    ct = _x(out_shape, seed)
    ref = jax.jit(lambda a, c: jax.vjp(jf, a)[1](c)[0])(jin, jnp.asarray(ct))
    tin = jax_bridge.tree_map(lambda t: t.requires_grad_(True),
                              jax_bridge.from_numpy_tree(inputs))
    leaves = tree_leaves(tin)
    out = tf(tin)
    assert tuple(out.shape) == tuple(out_shape)
    grads = torch.autograd.grad(out, leaves, _t(ct))
    return [np.asarray(g) for g in jax.tree_util.tree_leaves(ref)], grads


def _close_rel(ref, out, what, rtol=GRAD_RTOL):
    ref = np.asarray(ref, np.float32)
    atol = rtol * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# (a) the plane's layers: resampling, modulated convolution, the generator
# ---------------------------------------------------------------------------

def _modconv_case(ksize, **kw):
    p = jsg.init_modulated_conv(jax.random.key(ksize), 3, 5, ksize, 4)
    p["b"] = jnp.asarray(_x(5, 7))
    inputs = {"p": jax.tree.map(np.asarray, p), "x": _x((2, 3, 6, 6)),
              "z": _x((2, 4), 1)}
    return (inputs,
            lambda a: jsg.modulated_conv2d(a["p"], a["x"], a["z"], **kw),
            lambda a: tsg.modulated_conv2d(a["p"], a["x"], a["z"], **kw))


def _resample_case(op, **kw):
    return ({"x": _x((2, 3, 7, 6))},
            lambda a: getattr(jup, op)(a["x"], **kw),
            lambda a: getattr(tup, op)(a["x"], **kw))


def _generator_case():
    cfg = _smoke_meta(jcur).field_config()
    p = jsg.init_style_generator_2d(jax.random.key(3), out_res=cfg.grid_res,
                                    out_ch=cfg.grid_ch, z_dim=cfg.z_dim,
                                    ch_max=cfg.ch_max)
    inputs = {"p": jax.tree.map(np.asarray, p), "z": _x((2, cfg.z_dim))}
    return (inputs, lambda a: jsg.style_generator_2d(a["p"], a["z"]),
            lambda a: tsg.style_generator_2d(a["p"], a["z"]))


PLANE_CASES = {
    "upsample2d": lambda: _resample_case("upsample2d"),
    "downsample2d": lambda: _resample_case("downsample2d"),
    "blur": lambda: _resample_case("blur", pad=(2, 1)),
    "modconv": lambda: _modconv_case(3),
    "modconv_up": lambda: _modconv_case(3, upsample=True),
    "modconv_up_k1": lambda: _modconv_case(1, upsample=True,
                                           demodulate=False,
                                           activate=False),
    "modconv_down": lambda: _modconv_case(3, downsample=True),
    "style_generator_2d": _generator_case,
}


@pytest.mark.parametrize("case", sorted(PLANE_CASES))
def test_plane_layer_gradients_match_jax(case):
    inputs, jf, tf = PLANE_CASES[case]()
    ref, out = _vjps(jf, tf, inputs)
    assert len(ref) == len(out)
    for i, (a, b) in enumerate(zip(ref, out)):
        _close_rel(a, b, f"{case} leaf {i}")


def test_conv_backward_runs_under_exact_convs(monkeypatch):
    """Autograd runs a convolution's backward after its forward's `with`
    has closed: the plane's convolutions set TF32 off and cuDNN's
    deterministic algorithms for their backward themselves, whatever the
    process has set."""
    seen = []
    plain = tup._conv_backward

    def watch(*args):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cudnn.deterministic, args[7]))
        return plain(*args)

    monkeypatch.setattr(tup, "_conv_backward", watch)
    inputs, _, tf = _modconv_case(3, upsample=True)
    tin = jax_bridge.tree_map(lambda t: t.requires_grad_(True),
                              jax_bridge.from_numpy_tree(inputs))
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    benchmark=False, deterministic=False,
                                    allow_tf32=True):
        tf(tin).square().sum().backward()
        assert torch.backends.cudnn.allow_tf32
    # the transposed convolution and the blur's depthwise one
    assert {s[2] for s in seen} == {True, False}
    assert all(s[:2] == (False, True) for s in seen), seen


# ---------------------------------------------------------------------------
# (b) grid_sample_2d's plane gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spread", [1.2, 0.1])
def test_grid_sample_2d_gradients_match_jax(spread):
    """Samples inside and outside the plane (1.2), and crowded into a few
    cells (0.1), where the backward's index_put accumulates many terms
    into one texel."""
    rng = np.random.default_rng(4)
    inputs = {"coords": rng.uniform(-spread, spread, (300, 2)).astype(
        np.float32), "grid": _x((8, 8, 8), 2)}
    ref, out = _vjps(lambda a: jgs2d(a["grid"], a["coords"]),
                     lambda a: tgs2d(a["grid"], a["coords"]), inputs)
    for what, a, b in zip(("coords", "grid"), ref, out):
        _close_rel(a, b, what)


# ---------------------------------------------------------------------------
# (c) the grid field's VJP per parameter group
# ---------------------------------------------------------------------------

GROUPS = ("color", "color_head", "map", "sigma_head", "style_gen", "trunk")


@pytest.fixture(scope="module")
def field_vjps():
    """jax.vjp and torch's autograd of apply_grid_field at smoke_grid's
    widths, f32 (the trainer's compute_dtype), on points inside the box
    and the plane computed from z inside the field."""
    jcfg = _smoke_meta(jcur).field_config()
    tcfg = _smoke_meta(tcur).field_config()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    p = jax.tree.map(np.asarray, jlgf.init_grid_field(jax.random.key(0),
                                                      jcfg))
    rng = np.random.default_rng(6)
    pts = rng.uniform(-0.12, 0.12, (2, 48, 3)).astype(np.float32)
    dirs = _x((2, 48, 3), 7)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    z = _x((2, jcfg.z_dim), 8)
    ref, out = _vjps(
        lambda a: jlgf.apply_grid_field(a, jcfg, jnp.asarray(pts),
                                        jnp.asarray(dirs), jnp.asarray(z)),
        lambda a: tlgf.apply_grid_field(a, tcfg, _t(pts), _t(dirs), _t(z)),
        p)
    # leaves by top-level group (sorted keys: the tree_util order)
    counts = {k: len(jax.tree_util.tree_leaves(p[k])) for k in sorted(p)}
    assert tuple(counts) == GROUPS
    by_group, i = {}, 0
    for k, n in counts.items():
        by_group[k] = (ref[i:i + n], out[i:i + n])
        i += n
    return by_group


@pytest.mark.parametrize("group", GROUPS)
def test_grid_field_vjp_matches_jax(field_vjps, group):
    ref, out = field_vjps[group]
    assert_grads_match(np.concatenate([np.ravel(a) for a in ref]),
                       torch.cat([b.flatten() for b in out]).numpy(), group)
    for i, (a, b) in enumerate(zip(ref, out)):
        assert np.abs(a).max() > 0, f"{group} leaf {i} has no gradient"
        assert_grads_match(a, b.numpy(), f"{group} leaf {i}")


# ---------------------------------------------------------------------------
# (d) one whole train_step against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", [1, 2])
def test_grid_step_matches_jax(split):
    jmeta = _smoke_meta(jcur, batch_split=split, betas=(0.0, 0.9))
    tmeta = _smoke_meta(tcur, batch_split=split, betas=(0.0, 0.9))
    b, size = jmeta.batch_size, jmeta.img_size
    tstate = tloop.init_train_state(tmeta, seed=0, device="cpu")
    jstate = _jax_state(jmeta, tstate)
    before = {k: [t.clone() for t in tree_leaves(getattr(tstate, k))]
              for k in jax_bridge.TRAIN_PARAMS}
    # the bridge both ways on a grid state, leaf for leaf
    back = jax_bridge.train_params_from_numpy(jax.tree.map(np.asarray,
                                                           jstate))
    for k in jax_bridge.TRAIN_PARAMS:
        assert all(torch.equal(a, c) for a, c in
                   zip(tree_leaves(back[k]), before[k])), k
    imgs = np.random.default_rng(0).uniform(-1, 1, (b, 3, size, size)
                                            ).astype(np.float32)
    labels = np.zeros((b, 0, size, size), np.float32)
    alpha, noise, topk = 0.5, 0.7, 0.75
    jscal = jloop.StepScalars(alpha=jnp.asarray(alpha),
                              noise_std=jnp.asarray(noise),
                              topk_frac=jnp.asarray(topk))
    key = jax.random.key(1)
    jnew, jm = jax.jit(jloop.train_step, static_argnums=(5,))(
        jstate, jnp.asarray(imgs), jnp.asarray(labels), key, jscal, jmeta)
    draws = jax_step_draws(key, jmeta, b, jscal.noise_std)
    assert draws.z_img[1].shape == (b, 0)
    tnew, tm = tloop.train_step(
        tstate, _t(imgs), _t(labels),
        tloop.StepScalars(alpha=torch.tensor(alpha),
                          noise_std=torch.tensor(noise),
                          topk_frac=torch.tensor(topk)), tmeta, draws=draws)
    for k in ("d_img_loss", "g_loss", "g_img_loss", "fake_opacity"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3,
                                   err_msg=k)
    assert float(tm["d_seg_loss"]) == float(jm["d_seg_loss"]) == 0.0
    # gradients: Adam's first moment equals the (clipped) gradient at b1 = 0
    for name, jopt, topt in (("g", jnew.opt_g, tnew.opt_g),
                             ("d_img", jnew.opt_img, tnew.opt_img)):
        jmu = _jax_moments(jopt, False)
        assert sorted(jmu) == sorted(topt.mu)
        for group in topt.mu:
            for i, (a, c) in enumerate(zip(jax.tree.leaves(jmu[group]),
                                           tree_leaves(topt.mu[group]))):
                assert_grads_match(a, c.numpy(), f"{name}/{group}/{i}")
    # updated parameters within 2 lr of the JAX step's: Adam's first
    # update moves each entry by lr * g / |g|, so a gradient entry near 0
    # whose sign the two orders of summation flip lands 2 lr apart; plus
    # the f32 rounding of the new value (F32_ROUND of it: the mapping
    # weights of the style generator reach ~300, an ulp of 3e-5). No D_seg
    # phase: its critic stays as it was.
    for name, lr in (("g_params", tmeta.gen_lr),
                     ("d_img_params", tmeta.disc_img_lr),
                     ("d_seg_params", tmeta.disc_seg_lr)):
        moved = 0.0
        for a, c, c0 in zip(jax.tree.leaves(getattr(jnew, name)),
                            tree_leaves(getattr(tnew, name)), before[name]):
            np.testing.assert_allclose(c.numpy(), np.asarray(a),
                                       atol=2 * lr, rtol=F32_ROUND)
            moved += float((c - c0).abs().sum())
        assert (moved > 0) == (name != "d_seg_params"), name
    assert tnew.opt_seg.count == 0 and tnew.opt_img.count == 1
    for a, c in zip(jax.tree.leaves(jnew.ema.params),
                    tree_leaves(tnew.ema.params)):
        np.testing.assert_allclose(c.numpy(), np.asarray(a),
                                   atol=2 * tmeta.gen_lr, rtol=F32_ROUND)
    assert tnew.step == int(jnew.step) == 1


# ---------------------------------------------------------------------------
# (e) the port's own step moves every part of G
# ---------------------------------------------------------------------------

def test_updates_propagate_to_grid_params():
    meta = _smoke_meta(tcur)
    state = tloop.init_train_state(meta, seed=0, device="cpu")
    assert set(state.g_params) == set(GROUPS)
    parts = ("style_gen", "map", "trunk")
    before = {k: [t.clone() for t in tree_leaves(state.g_params[k])]
              for k in parts}
    ema0 = [t.clone() for t in tree_leaves(state.ema.params)]
    b, size = meta.batch_size, meta.img_size
    g = torch.Generator().manual_seed(2)
    imgs = torch.rand(b, 3, size, size, generator=g) * 2 - 1
    new, m = tloop.train_step(
        state, imgs, torch.zeros(b, 0, size, size),
        tloop.StepScalars(alpha=1.0, noise_std=0.5, topk_frac=1.0), meta,
        generator=g)
    for k in parts:
        assert any(not torch.equal(x, y) for x, y in
                   zip(before[k], tree_leaves(new.g_params[k]))), \
            f"{k} did not update"
    assert any(not torch.equal(x, y) for x, y in
               zip(ema0, tree_leaves(new.ema.params)))
    assert all(np.isfinite(float(m[k])) for k in ("g_loss", "d_img_loss"))


# ---------------------------------------------------------------------------
# (f) a JAX grid train_state.npz through the port and back
# ---------------------------------------------------------------------------

def test_grid_train_state_round_trip(tmp_path):
    """Every leaf perturbed: loaded leaf for leaf, one step in the port,
    saved and loaded back by the JAX package leaf for leaf."""
    jmeta, tmeta = _smoke_meta(jcur), _smoke_meta(tcur)
    fresh = tloop.init_train_state(tmeta, seed=1, device="cpu")
    jst = perturbed(_jax_state(jmeta, fresh))
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, jst)
    tst = tckpt.load(path, fresh)
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jst)]
    tleaves = tckpt.state_leaves(tst)
    assert len(jleaves) == len(tleaves)
    for i, (a, c) in enumerate(zip(jleaves, tleaves)):
        np.testing.assert_array_equal(c, a.astype(c.dtype), err_msg=str(i))
    assert tst.step == int(jst.step) and tst.opt_g.split == ()
    b, size = tmeta.batch_size, tmeta.img_size
    g = torch.Generator().manual_seed(3)
    tst, m = tloop.train_step(
        tst, torch.rand(b, 3, size, size, generator=g) * 2 - 1,
        torch.zeros(b, 0, size, size),
        tloop.StepScalars(alpha=1.0, noise_std=0.5, topk_frac=1.0), tmeta,
        generator=g)
    assert np.isfinite(float(m["g_loss"]))
    assert tst.step == int(jst.step) + 1
    path2 = str(tmp_path / "port.npz")
    tckpt.save(path2, tst)
    back = jckpt.load(path2, _jax_state(jmeta, fresh))
    for i, (a, c) in enumerate(zip(jax.tree_util.tree_leaves(back),
                                   tckpt.state_leaves(tst))):
        np.testing.assert_array_equal(np.asarray(a), c, err_msg=str(i))
    assert int(back.step) == tst.step
