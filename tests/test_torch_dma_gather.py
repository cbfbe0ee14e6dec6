"""Port parity: the ceiling probes' gather (fenerf_tpu_torch/ops/
dma_gather.py::ring_dma_gather) on the CPU, where the wrapper runs its plain
torch version, against the JAX script's Pallas kernel
(scripts/profile_dma_gather.py) in interpret mode, on the same
numpy-seeded inputs; the overlapped chain against
scripts/profile_mxu_chain.py::run_chain. The CUDA kernel's own tests are in
tests/test_torch_kernel_cuda.py.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
import torch

from fenerf_tpu_torch.ops import dma_gather as dg
from fenerf_tpu_torch.ops import mxu_chain as mc

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ROWS = 3000
N = 1024   # the JAX kernel's tile: its n must be a multiple of it


def _load_script(name: str):
    """scripts/<name>.py as a module. The scripts point JAX's persistent
    compilation cache at ~/.cache when imported; that is undone here, so
    no test writes there."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


jgather = _load_script("profile_dma_gather")
jchain = _load_script("profile_mxu_chain")


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _inputs(row_shape=(8, 128), n=N, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((ROWS,) + row_shape).astype(np.float32)
    idx = rng.integers(0, ROWS, n).astype(np.int32)
    return ((jnp.asarray(table).astype(jnp.bfloat16), jnp.asarray(idx)),
            (torch.from_numpy(table).bfloat16(), torch.from_numpy(idx)))


def _bits(a):
    """bf16 values as their 16-bit patterns (bit-exact comparison)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("ring", [16, 64])
def test_gather_equals_jax_kernel(interpret_pallas, ring):
    (jt, ji), (tt, ti) = _inputs(seed=ring)
    ref = jgather.ring_dma_gather(jt, ji, ring=ring)
    calls, launches = dg.gather_reference.calls, dg.ring_dma_gather.launches
    out = dg.ring_dma_gather(tt, ti, ring)
    assert (dg.gather_reference.calls, dg.ring_dma_gather.launches) == (
        calls + 1, launches)          # the CPU route is the plain version
    assert out.shape == (N, 8, 128) and out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(out), _bits(ref))


def test_overlap_equals_jax_kernel(interpret_pallas):
    """The gathered rows bit-exact against the JAX overlap kernel; the
    chain output (the JAX kernel's act_ref, which it does not return)
    against the JAX chain kernel on the same activation."""
    (jt, ji), (tt, ti) = _inputs(seed=3)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((N, 256)) * 0.1).astype(np.float32)
    ws = [(rng.standard_normal((256, 256)) / 16).astype(np.float32)
          for _ in range(jgather.LAYERS)]
    jws = [jnp.asarray(w).astype(jnp.bfloat16) for w in ws]
    tws = [torch.from_numpy(w).bfloat16() for w in ws]
    ref_rows = jgather.ring_dma_gather(jt, ji, ring=16, ws=jws, overlap=True)
    ref_act = jchain.run_chain(jnp.asarray(x).astype(jnp.bfloat16), jws,
                               tile=N)
    rows, act = dg.ring_dma_gather(tt, ti, 16, ws=tws,
                                   x=torch.from_numpy(x).bfloat16(),
                                   overlap=True)
    np.testing.assert_array_equal(_bits(rows), _bits(ref_rows))
    ref_act = np.asarray(ref_act.astype(jnp.float32))
    err = np.abs(act.float().numpy() - ref_act).max() / np.abs(ref_act).max()
    assert err <= 2e-2
    # without x, the chain runs on zeros, as the JAX kernel's does
    rows0, act0 = dg.ring_dma_gather(tt, ti, 16, ws=tws, overlap=True)
    assert torch.equal(rows0, rows) and not act0.any()


@pytest.mark.parametrize("row_shape,n", [((256,), N + 37), ((8, 128), 5),
                                         ((24,), 300)])
def test_gather_takes_other_rows_and_ragged_counts(row_shape, n):
    """The flagship's 512 B row, a count that is not a multiple of the
    tile, a row that is not a power of two of 16 bytes."""
    _, (tt, ti) = _inputs(row_shape, n, seed=5)
    ring = dg.rings(2 * tt[0].numel())[-1]
    out = dg.ring_dma_gather(tt, ti, ring)
    assert out.shape == (n,) + row_shape
    np.testing.assert_array_equal(_bits(out), _bits(tt)[ti.numpy()])


@pytest.mark.parametrize("row_bytes", [16, 48, 512, 2048, 8192])
@pytest.mark.parametrize("overlap", [False, True])
def test_rings_follow_the_shared_memory_rule(row_bytes, overlap):
    """The rings the card takes are the powers of two from 1 up to what a
    CTA's 227 KB of shared memory holds: the tile's 1024 indices, a slot of
    one row and an 8-byte barrier per ring entry, and beside the chain its
    64-row sub-tile."""
    got = dg.rings(row_bytes, overlap)
    assert got == tuple(1 << k for k in range(len(got)))
    chain = mc.group_smem(64, 256, 8) if overlap else 0
    for ring in (1, got[-1], 2 * got[-1]):
        assert dg.gather_smem(row_bytes, ring, 256, overlap) == (
            4 * dg.TILE + ring * (row_bytes + 8) + chain)
    assert dg.gather_smem(row_bytes, got[-1], 256, overlap) <= mc.MAX_SMEM
    assert dg.gather_smem(row_bytes, 2 * got[-1], 256, overlap) > mc.MAX_SMEM


def test_rings_the_card_takes():
    """The rings at the probes' row sizes; every ring the JAX script and
    the port's probe script time is among them, at both row sizes and
    beside the chain."""
    spec = importlib.util.spec_from_file_location(
        "_torch_profile_dma_gather",
        ROOT / "scripts" / "profile_torch_dma_gather.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert dg.rings(2048) == (1, 2, 4, 8, 16, 32, 64)
    assert dg.rings(512) == (1, 2, 4, 8, 16, 32, 64, 128, 256)
    assert dg.rings(2048, overlap=True) == (1, 2, 4, 8, 16, 32)
    assert {16, 64} | set(script.RINGS) <= set(dg.rings(2048))
    assert set(script.RINGS_512B) <= set(dg.rings(512))
    assert set(script.OVERLAP_RINGS) <= set(dg.rings(2048, overlap=True))
    assert set(script.OVERLAP_RINGS) <= set(dg.rings(16, overlap=True))


def _bad_inputs():
    table = torch.zeros(10, 8, 128, dtype=torch.bfloat16)
    idx = torch.zeros(4, dtype=torch.int32)
    ws = [torch.zeros(256, 256, dtype=torch.bfloat16)]
    return [
        ("table must", lambda: dg.ring_dma_gather(table.float(), idx, 16)),
        ("multiple of 16", lambda: dg.ring_dma_gather(
            torch.zeros(10, 3, dtype=torch.bfloat16), idx, 16)),
        ("idx must", lambda: dg.ring_dma_gather(table, idx.long(), 16)),
        ("idx must", lambda: dg.ring_dma_gather(table, idx[:0], 16)),
        ("ring", lambda: dg.ring_dma_gather(table, idx, 128)),
        ("ring", lambda: dg.ring_dma_gather(table, idx, 3)),
        ("needs ws", lambda: dg.ring_dma_gather(table, idx, 16,
                                                overlap=True)),
        ("one row per index", lambda: dg.ring_dma_gather(
            table, idx, 16, ws=ws, x=torch.zeros(5, 256,
                                                 dtype=torch.bfloat16),
            overlap=True)),
        ("ring", lambda: dg.ring_dma_gather(table, idx, 64, ws=ws,
                                            overlap=True)),
    ]


@pytest.mark.parametrize("case", range(len(_bad_inputs())))
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    match, call = _bad_inputs()[case]
    with pytest.raises(ValueError, match=match):
        call()
