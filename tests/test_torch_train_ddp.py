"""The port's data-parallel train step (train/sharding.py::
train_step_sharded over train/loop.py::train_step) on two gloo ranks on
the CPU, held to fenerf_tpu.train.loop.train_step on the GLOBAL batch: the
oracle the JAX package's mesh-size invariance rests on (XLA's program gives
the same answer at any mesh size, tests/test_train_step.py:362-408).

Global batch 8 (4 per rank), batch_split 2, topk_frac 0.6: a chunk of 4
keeps ceil(2.4) = 3 fakes, so each chunk's kept set is decided across the
ranks. Both model families (the texture flagship at tests/
test_torch_train_step.py's widths, smoke_grid), the split loop and
full_batch. The JAX step runs at full_batch on its own replayed draws; the
port's split loop takes the same draws cut into microbatches (the two
modes compute one objective, StageMeta.full_batch).

Tolerances: against JAX, test_torch_train_step.py's (losses rtol 1e-3,
gradients by cosine and norm, updated parameters within 2 lr, plus the f32
rounding of the value); against the port's one-process step on the same
draws, the JAX package's mesh bounds (losses atol 1e-3, parameters atol
5e-4: only the order of the reductions differs); the ranks' states after
two steps bit-identical.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fenerf_tpu.train import curriculum as jcur
from fenerf_tpu.train import ema as jema
from fenerf_tpu.train import loop as jloop
from fenerf_tpu_torch.compat import jax_bridge
from fenerf_tpu_torch.compat.jax_bridge import tree_leaves
from fenerf_tpu_torch.models import generator as tgen
from fenerf_tpu_torch.train import curriculum as tcur
from fenerf_tpu_torch.train import loop as tloop

import torch_ranks
from test_torch_train_step import (_jax_moments, assert_grads_match,
                                   jax_step_draws, tiny_texture_meta)

torch.set_num_threads(2)

CASES = [("texture", False), ("texture", True), ("grid", False),
         ("grid", True)]
B, SPLIT, TOPK, ALPHA, NOISE = 8, 2, 0.6, 0.5, 0.7
F32_ROUND = 2.0 ** -22
METRICS = ("d_img_loss", "d_seg_loss", "g_loss", "g_img_loss",
           "g_seg_loss", "fake_opacity")


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _meta(cur, family, **kw):
    kw = dict(batch_size=B, batch_split=SPLIT, betas=(0.0, 0.9), **kw)
    if family == "texture":
        return tiny_texture_meta(cur, **kw)
    return dataclasses.replace(cur.CURRICULA["smoke_grid"].at_step(0), **kw)


def _jax_state(jmeta, tstate):
    """The JAX package's step-0 TrainState around a port state's networks
    (tests/test_torch_grid_train.py::_jax_state)."""
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


def _split(parts, s):
    """One whole-batch render's draws (or None) cut into s microbatches'."""
    if parts is None:
        return None
    (d,) = parts
    n = d.jitter.shape[0] // s
    cut = lambda t, i: None if t is None else t[i * n:(i + 1) * n]
    return [tgen.RenderDraws(
        cut(d.jitter, i), cut(d.cam_h, i), cut(d.cam_v, i),
        tgen.RayNoise(*(cut(t, i) for t in d.noise)))
        for i in range(s)]


def _case_inputs(family, full_batch, key):
    jmeta = _meta(jcur, family, full_batch=True)
    draws = jax_step_draws(key, jmeta, B, jnp.asarray(NOISE))
    if not full_batch:
        draws = draws._replace(fakes_img=_split(draws.fakes_img, SPLIT),
                               fakes_seg=_split(draws.fakes_seg, SPLIT),
                               g_renders=_split(draws.g_renders, SPLIT))
    tmeta = _meta(tcur, family, full_batch=full_batch)
    size, n_lab = tmeta.img_size, (18 if family == "texture" else 0)
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-1, 1, (B, 3, size, size)).astype(np.float32)
    labels = rng.uniform(-1, 1, (B, n_lab, size, size)).astype(np.float32)
    scal = tloop.StepScalars(alpha=torch.tensor(ALPHA),
                             noise_std=torch.tensor(NOISE),
                             topk_frac=torch.tensor(TOPK))
    return jmeta, dict(meta=tmeta, imgs=imgs, labels=labels, scal=scal,
                       draws=draws)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results for every case (one launch), the JAX steps (one
    per family, at full_batch) and the port's one-process steps."""
    out = tmp_path_factory.mktemp("ddp")
    key = jax.random.key(1)
    inputs = {c: _case_inputs(*c, key) for c in CASES}
    procs = torch_ranks.launch("train", {"cases": [inputs[c][1]
                                                   for c in CASES]}, out)
    try:
        jax_ref = {}
        for family in ("texture", "grid"):
            jmeta, case = inputs[(family, True)]
            jstate = _jax_state(jmeta, tloop.init_train_state(
                case["meta"], seed=0, device="cpu"))
            jscal = jloop.StepScalars(alpha=jnp.asarray(ALPHA),
                                      noise_std=jnp.asarray(NOISE),
                                      topk_frac=jnp.asarray(TOPK))
            jnew, jm = jax.jit(jloop.train_step, static_argnums=(5,))(
                jstate, jnp.asarray(case["imgs"]),
                jnp.asarray(case["labels"]), key, jscal, jmeta)
            jax_ref[family] = (jnew, {k: float(v) for k, v in jm.items()})
        one = {}
        for c in CASES:
            case = inputs[c][1]
            st = tloop.init_train_state(case["meta"], seed=0, device="cpu")
            st, m = tloop.train_step(st, _t(case["imgs"]),
                                     _t(case["labels"]), case["scal"],
                                     case["meta"], draws=case["draws"])
            one[c] = (st, {k: float(v) for k, v in m.items()})
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    ranks = torch_ranks.collect(procs, "train", out, timeout=600)
    return {c: (inputs[c][1]["meta"], [r[i] for r in ranks],
                jax_ref[c[0]], one[c]) for i, c in enumerate(CASES)}


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-"
                         f"{'full_batch' if c[1] else 'split'}")
def test_two_ranks_match_jax_global_step(run, case):
    meta, ranks, (jnew, jm), _ = run[case]
    assert [r["batch"] for r in ranks] == [B // 2] * 2
    for r in ranks:
        for k in METRICS:
            np.testing.assert_allclose(r["metrics"][k], jm[k], rtol=1e-3,
                                       atol=1e-7, err_msg=k)
    mu = ranks[0]["mu"]
    nets = [("g", jnew.opt_g, "opt_g"), ("d_img", jnew.opt_img, "opt_img")]
    if case[0] == "texture":
        nets.append(("d_seg", jnew.opt_seg, "opt_seg"))
    for name, jopt, key in nets:
        jmu = _jax_moments(jopt, name == "g")
        for k in mu[key]:
            for i, (a, b) in enumerate(zip(jax.tree.leaves(jmu[k]),
                                           tree_leaves(mu[key][k]))):
                assert_grads_match(a, b, f"{name}/{k}/{i}")
    for a, b in zip(jax.tree.leaves(jnew.g_params),
                    tree_leaves(ranks[0]["g_params"])):
        np.testing.assert_allclose(b, np.asarray(a), atol=2 * meta.gen_lr,
                                   rtol=F32_ROUND)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-"
                         f"{'full_batch' if c[1] else 'split'}")
def test_two_ranks_match_one_process(run, case):
    _, ranks, _, (st, m) = run[case]
    for r in ranks:
        for k in METRICS:
            np.testing.assert_allclose(r["metrics"][k], m[k], atol=1e-3,
                                       err_msg=k)
    for a, b in zip(tree_leaves(st.g_params),
                    tree_leaves(ranks[0]["g_params"])):
        np.testing.assert_allclose(b, a.numpy(), atol=5e-4, rtol=0)
    for key in ("opt_g", "opt_img", "opt_seg"):
        mu = ranks[0]["mu"][key]
        for k in mu:
            for i, (a, b) in enumerate(zip(tree_leaves(getattr(st, key).mu[k]),
                                           tree_leaves(mu[k]))):
                assert_grads_match(a.numpy(), b, f"{key}/{k}/{i}",
                                   cos_min=0.9999, rtol=1e-3)


def test_ranks_bit_identical_after_two_steps(run):
    for case in CASES:
        ranks = run[case][1]
        assert [r["replicas"] for r in ranks] == ["identical"] * 2, case
        assert [r["step"] for r in ranks] == [2, 2]
        np.testing.assert_array_equal(ranks[0]["step2_g"],
                                      ranks[1]["step2_g"])
