"""Port parity for the CCS double-encoder critics
(fenerf_tpu_torch/nn/discriminators.py) against fenerf_tpu's on the same
parameters (HWIO weights carried over as they are), and R1's gradient
against jax.grad; plus the rule that the port imports nothing of JAX.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fenerf_tpu.nn import discriminators as jdisc
from fenerf_tpu_torch.compat.jax_bridge import from_numpy_tree, tree_leaves
from fenerf_tpu_torch.nn import discriminators as tdisc

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _critics(input_dim):
    jcfg = jdisc.DiscriminatorConfig(input_dim=input_dim, latent_geo_dim=8,
                                     latent_app_dim=8)
    tcfg = tdisc.DiscriminatorConfig(input_dim=input_dim, latent_geo_dim=8,
                                     latent_app_dim=8)
    jp = jdisc.init_discriminator(jax.random.key(0), jcfg)
    return jcfg, tcfg, jp, from_numpy_tree(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("size,alpha,input_dim", [
    (16, 1.0, 3), (16, 0.3, 21), (32, 1.0, 21), (32, 0.6, 3)])
def test_apply_matches_jax(size, alpha, input_dim):
    jcfg, tcfg, jp, tp = _critics(input_dim)
    x = np.random.default_rng(size).uniform(
        -1, 1, (2, input_dim, size, size)).astype(np.float32)
    ref = jdisc.apply_discriminator(jp, jcfg, jnp.asarray(x), alpha)
    out = tdisc.apply_discriminator(tp, tcfg, _t(x), alpha)
    for r, o in zip(ref, out):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                   atol=1e-4, rtol=1e-4)


def test_init_tree_matches_jax():
    jcfg, tcfg, jp, _ = _critics(21)
    tp = tdisc.init_discriminator(torch.Generator().manual_seed(0), tcfg)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = tree_leaves(tp)
    assert len(jl) == len(tl)
    for (path, a), t in zip(jl, tl):
        assert tuple(a.shape) == tuple(t.shape), path
        if a.size >= 64:
            assert 0.5 < float(t.std()) / max(float(np.std(a)), 1e-12) < 2.0


def test_r1_gradient_matches_jax():
    """The R1 term's input gradient and the gradient of the R1 penalty
    w.r.t. the critic's parameters (double backprop)."""
    jcfg, tcfg, jp, tp = _critics(3)
    x = np.random.default_rng(7).uniform(-1, 1, (2, 3, 16, 16)).astype(
        np.float32)

    def jr1(p):
        g = jax.grad(lambda xx: jdisc.apply_discriminator(
            p, jcfg, xx, 0.5)[0].sum())(jnp.asarray(x))
        return 0.5 * 0.2 * (g.reshape(2, -1) ** 2).sum(-1).mean(), g

    (jval, jg), jdp = jax.value_and_grad(jr1, has_aux=True)(jp)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    s = tdisc.apply_discriminator(tp, tcfg, xt, 0.5)[0]
    (g,) = torch.autograd.grad(s.sum(), xt, create_graph=True)
    r1 = 0.5 * 0.2 * (g.reshape(2, -1) ** 2).sum(-1).mean()
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(jg),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(r1.item(), float(jval), rtol=1e-4)
    dps = torch.autograd.grad(r1, leaves, allow_unused=True)
    used = 0
    for a, b in zip(jax.tree.leaves(jdp), dps):
        if b is None:   # a block the 16^2 input does not reach
            assert not np.asarray(a).any()
            continue
        used += 1
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=1e-3)
    assert used > 10


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "fenerf_tpu_torch").rglob("*.py"))
    probes = sorted((ROOT / "scripts").glob("profile_torch_*.py"))
    assert len(probes) >= 5   # serve, train and the three ceiling probes
    files += probes + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "fenerf_tpu", "optax",
                                  "flax", "PIL", "cv2")]
    assert not bad, bad
