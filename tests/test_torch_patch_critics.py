"""The SPADE-style patch critics (nn/discriminators.py's
NLayerDiscriminator / MultiscaleDiscriminator with stateful spectral norm)
against the JAX package's on the JAX parameters carried across by
compat/jax_bridge.py (u and v, and the Python int / bool leaves, included):
every feature map within 1e-4 of its largest magnitude (f32), the spectral
norm's u threaded through 30 calls within 1e-5 of the JAX u's, sigma
within 1e-3 of the SVD's top singular value, and the input gradient
against jax.grad within 1e-4 relative."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fenerf_tpu.nn import discriminators as jd
from fenerf_tpu_torch.compat.jax_bridge import (from_numpy_tree,
                                                to_numpy_tree, tree_leaves)
from fenerf_tpu_torch.nn import discriminators as td

torch.set_num_threads(2)

KW = dict(input_nc=22, ndf=8, n_layers=3)
MAP_TOL = 1e-4
U_TOL = 1e-5


def _input(seed, b=2, size=32):
    return np.random.RandomState(seed).standard_normal(
        (b, KW["input_nc"], size, size)).astype(np.float32)


def _maps(out):
    """A critic's output (a map, a list of maps, or a list of lists) as
    a flat list of numpy arrays."""
    if isinstance(out, (list, tuple)):
        return [m for o in out for m in _maps(o)]
    return [np.asarray(out.detach().numpy() if hasattr(out, "detach")
                       else out)]


def _close_maps(got, ref):
    got, ref = _maps(got), _maps(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        scale = float(np.abs(r).max())
        assert scale > 0
        assert float(np.abs(g - r).max()) <= MAP_TOL * scale


def test_tree_carries_static_leaves():
    """The JAX tree's int / bool leaves (stride, sn) and the optional v
    cross to the port and back as they are."""
    jp = jd.init_nlayer_discriminator(jax.random.key(0), **KW)
    jp["layers"][1]["v"] = jnp.ones((8 * 4 * 4,))
    tp = from_numpy_tree(jp)
    for jl, tl in zip(jp["layers"], tp["layers"]):
        assert sorted(jl) == sorted(tl)
        assert type(tl["stride"]) is int and tl["stride"] == jl["stride"]
        assert type(tl["sn"]) is bool and tl["sn"] == jl["sn"]
    assert isinstance(tp["layers"][1]["v"], torch.Tensor)
    back = to_numpy_tree(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        if isinstance(a, (bool, int)):
            assert type(b) is type(a) and b == a
        else:
            np.testing.assert_array_equal(np.asarray(a), b)
    assert len(tree_leaves(tp)) == len(jax.tree.leaves(jp))


@pytest.mark.parametrize("get_interm", [False, True])
def test_nlayer(get_interm):
    jp = jd.init_nlayer_discriminator(jax.random.key(1), **KW)
    x = _input(0)
    ref = jd.apply_nlayer_discriminator(jp, jnp.asarray(x), get_interm)
    got = td.apply_nlayer_discriminator(from_numpy_tree(jp),
                                        torch.from_numpy(x), get_interm)
    if get_interm:
        assert len(got) == KW["n_layers"] + 2
    _close_maps(got, ref)


@pytest.mark.parametrize("num_d,get_interm", [(2, True), (3, True),
                                              (3, False)])
def test_multiscale(num_d, get_interm):
    jp = jd.init_multiscale_discriminator(jax.random.key(2), num_d=num_d,
                                          **KW)
    x = _input(num_d, size=40)    # 40 -> 20 -> 10: the pools' odd borders
    ref = jd.apply_multiscale_discriminator(jp, jnp.asarray(x), get_interm)
    got = td.apply_multiscale_discriminator(from_numpy_tree(jp),
                                            torch.from_numpy(x), get_interm)
    assert len(got) == num_d
    _close_maps(got, ref)


def test_eval_with_stored_v():
    """A layer holding v runs in eval mode: the stored u and v, u returned
    unchanged."""
    jp = jd.init_multiscale_discriminator(jax.random.key(3), num_d=2, **KW)
    rng = np.random.RandomState(5)
    for sub in jp["scales"]:
        for lyr in sub["layers"]:
            if lyr["sn"]:
                w = lyr["conv"]["w"]
                lyr["v"] = jnp.asarray(rng.standard_normal(
                    w.shape[0] * w.shape[1] * w.shape[2]).astype(np.float32))
    x = _input(6)
    ref, jstate = jd.apply_multiscale_discriminator(jp, jnp.asarray(x),
                                                    return_state=True)
    tp = from_numpy_tree(jp)
    got, tstate = td.apply_multiscale_discriminator(
        tp, torch.from_numpy(x), return_state=True)
    _close_maps(got, ref)
    for js, ts, sub in zip(jstate["scales"], tstate["scales"], tp["scales"]):
        for jl, tl, ol in zip(js["layers"], ts["layers"], sub["layers"]):
            if jl["sn"]:
                assert torch.equal(tl["u"], ol["u"])
                np.testing.assert_allclose(tl["u"].numpy(),
                                           np.asarray(jl["u"]), atol=U_TOL)


def test_state_threading_and_sigma():
    """30 calls carrying the returned u: the port's u within 1e-5 of the
    JAX u's at every layer, and sigma = u^T W v within 1e-3 of the SVD's
    top singular value (the power iteration converges there)."""
    jp = jd.init_multiscale_discriminator(jax.random.key(4), num_d=2, **KW)
    tp = from_numpy_tree(jp)
    x = _input(7, b=1, size=16)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)

    @jax.jit
    def japply(us):
        """The JAX call on the tree holding `us` (the int / bool leaves
        stay Python values, closed over) -> the updated u's."""
        it = iter(us)
        p = {"scales": [{"layers": [
            {**lyr, "u": next(it)} if lyr["sn"] else lyr
            for lyr in sub["layers"]]} for sub in jp["scales"]]}
        _, new = jd.apply_multiscale_discriminator(p, jx, return_state=True)
        return [lyr["u"] for sub in new["scales"] for lyr in sub["layers"]
                if lyr["sn"]]

    us = [lyr["u"] for sub in jp["scales"] for lyr in sub["layers"]
          if lyr["sn"]]
    for _ in range(30):
        us = japply(us)
        _, tp = td.apply_multiscale_discriminator(tp, tx, return_state=True)
    layers = [tl for ts in tp["scales"] for tl in ts["layers"] if tl["sn"]]
    assert len(layers) == len(us) == 2 * KW["n_layers"]
    for tl, ju in zip(layers, us):
        np.testing.assert_allclose(tl["u"].numpy(), np.asarray(ju),
                                   atol=U_TOL, rtol=0)
    # sigma at each scale's first spectral-norm layer, as the JAX package's
    # own convergence test holds it (the deeper layers' smaller spectral
    # gaps converge more slowly than 30 iterations)
    for tl in layers[::KW["n_layers"]]:
        w = tl["conv"]["w"]
        mat = w.permute(3, 2, 0, 1).reshape(w.shape[-1], -1)
        w_sn, _ = td._spectral_normalize(w, tl["u"])
        sigma = float(w.norm() / w_sn.norm())
        top = float(torch.linalg.svdvals(mat.double())[0])
        assert abs(sigma - top) <= 1e-3 * top, (sigma, top)


def test_input_gradient():
    jp = jd.init_multiscale_discriminator(jax.random.key(5), num_d=2, **KW)
    x = _input(8, size=24)

    def jloss(x):
        out = jd.apply_multiscale_discriminator(jp, x, get_interm=False)
        return sum(jnp.sum(o * o) for o in out)

    ref = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = td.apply_multiscale_discriminator(from_numpy_tree(jp), tx,
                                            get_interm=False)
    sum(torch.sum(o * o) for o in out).backward()
    got = tx.grad.numpy()
    assert float(np.abs(got - ref).max()) <= 1e-4 * float(np.abs(ref).max())


def test_init_shapes_match_jax():
    """The port's init draws a tree of the JAX init's structure and shapes
    (its own draws)."""
    jp = jd.init_multiscale_discriminator(jax.random.key(6), num_d=3, **KW)
    tp = td.init_multiscale_discriminator(torch.Generator().manual_seed(0),
                                          num_d=3, **KW)
    assert jax.tree.structure(to_numpy_tree(tp)) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        if isinstance(a, (bool, int)):
            assert a == b
        else:
            assert tuple(a.shape) == tuple(b.shape)
    # and it runs
    out = td.apply_multiscale_discriminator(tp, torch.from_numpy(_input(9)))
    assert all(torch.isfinite(m).all() for m in tree_leaves(out))
