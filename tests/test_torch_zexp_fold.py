"""Port parity for the texture-table fold (fenerf_tpu_torch/ops/zexp_fold.py)
against the JAX package's Pallas kernel (fenerf_tpu/ops/zexp_fold.py, in
interpret mode) and its XLA slice fold, on numpy-seeded cotangents; and the
dispatch by device of core/grid_sample.py::zexp_table_adjoint. On
the CPU the wrapper runs its plain version (the card tests hold the kernel
to it bit for bit).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fenerf_tpu.core.grid_sample import zexp_table_adjoint_xla
from fenerf_tpu.ops.zexp_fold import fold_zexp as jax_fold
from fenerf_tpu_torch.core import grid_sample as tgs
from fenerf_tpu_torch.ops import zexp_fold as tzf


def _cotangent(grid_shape, seed):
    c, d, h, w = grid_shape
    rows = (d + 1) * (h + 1) * (w + 1)
    return np.random.RandomState(seed).randn(rows, 8 * c).astype(np.float32)


@pytest.mark.parametrize("grid_shape,ytile", [
    ((3, 4, 5, 6), 32),
    ((3, 4, 5, 6), 4),
    ((8, 8, 8, 8), 3),
    ((2, 6, 3, 4), 2),
])
def test_fold_matches_jax(grid_shape, ytile):
    dt = _cotangent(grid_shape, 17)
    want = jax_fold(jnp.asarray(dt), grid_shape, ytile=ytile, interpret=True)
    calls = tzf.fold_zexp_reference.calls
    got = tzf.fold_zexp(torch.from_numpy(dt), grid_shape)
    assert tzf.fold_zexp_reference.calls == calls + 1
    assert tzf.fold_zexp.launches == 0   # no kernel on the CPU
    assert got.shape == grid_shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(zexp_table_adjoint_xla(jnp.asarray(dt),
                                                       grid_shape)),
        rtol=1e-6, atol=1e-6)


def test_bf16_cotangent_folds_to_f32():
    grid_shape = (4, 3, 3, 3)
    dt = _cotangent(grid_shape, 23)
    jb = jnp.asarray(dt).astype(jnp.bfloat16)
    want = jax_fold(jb, grid_shape, interpret=True)
    got = tzf.fold_zexp(torch.from_numpy(dt).to(torch.bfloat16), grid_shape)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_switch_dispatches_to_the_fold():
    """zexp_table_adjoint dispatches by device: a CPU tensor takes the slice
    fold, any other the fold kernel's wrapper (on a device without a kernel
    that wrapper raises; the card tests hold the CUDA dispatch)."""
    grid_shape = (2, 3, 4, 5)
    dt = torch.from_numpy(_cotangent(grid_shape, 29))
    calls = tzf.fold_zexp_reference.calls
    cpu = tgs.zexp_table_adjoint(dt, grid_shape)
    assert tzf.fold_zexp_reference.calls == calls   # the slice fold itself
    assert tzf.fold_zexp.launches == 0
    assert torch.equal(cpu, tzf.fold_zexp(dt, grid_shape))
    # the table build's backward reaches it too
    grid = torch.randn(grid_shape, requires_grad=True)
    table = tgs.build_zexp_table(grid)
    (g,) = torch.autograd.grad((table * dt).sum(), grid)
    assert torch.equal(g, cpu)
    with pytest.raises(ValueError, match="fold_zexp: no kernel for device"):
        tgs.zexp_table_adjoint(dt.to("meta"), grid_shape)


def test_switch_rejects_non_f32_out():
    grid_shape = (2, 3, 3, 3)
    dt = torch.from_numpy(_cotangent(grid_shape, 31))
    with pytest.raises(ValueError, match="float32"):
        tgs.zexp_table_adjoint(dt.to("meta"), grid_shape,
                               out_dtype=torch.bfloat16)
    assert tgs.zexp_table_adjoint(
        dt, grid_shape, out_dtype=torch.bfloat16).dtype == torch.bfloat16
