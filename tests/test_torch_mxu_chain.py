"""Port parity: the ceiling probes' chains (fenerf_tpu_torch/ops/mxu_chain.py:
run_chain, run_wide, run_epi) on the CPU, where each wrapper runs its plain
torch version, against the JAX scripts' Pallas kernels
(scripts/profile_mxu_chain.py, scripts/profile_epilogue_overlap.py) in
interpret mode, on the same numpy-seeded inputs. The CUDA kernel's own
tests are in tests/test_torch_kernel_cuda.py.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
import torch

from fenerf_tpu_torch.ops import mxu_chain as mc

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# chains: bf16 operands on both sides, f32 sums in another order
CHAIN_TOL = 2e-2
# the FiLM chain: a bf16 flip of one layer's output moves a later one by a
# few bf16 steps of [-1, 1]
EPI_TOL = 5e-2


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


jchain = _load_script("profile_mxu_chain")
jepi = _load_script("profile_epilogue_overlap")


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _pair(a: np.ndarray, dtype=jnp.bfloat16):
    """The same values for JAX and torch (bf16 rounding is RNE in both)."""
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(tdt)


def _chain_inputs(n, h, layers, seed=0):
    rng = np.random.default_rng(seed)
    x = _pair((rng.standard_normal((n, h)) * 0.1).astype(np.float32))
    ws = [_pair((rng.standard_normal((h, h)) / math.sqrt(h))
                .astype(np.float32)) for _ in range(layers)]
    return x, [w[0] for w in ws], [w[1] for w in ws]


def _film_inputs(layers, h, scale, seed=1):
    """(jax ws, torch ws, (b, f, p) pairs): the script's draw or the
    field's SIREN scale (ops/probes.py::film_inputs)."""
    rng = np.random.default_rng(seed)
    if scale == "script":
        w = rng.standard_normal((layers, h, h)) / math.sqrt(h)
        b = rng.standard_normal((layers, h)) * 0.1
    else:
        lim = math.sqrt(6 / h) / 30
        w = rng.uniform(-lim, lim, (layers, h, h))
        b = rng.uniform(-1, 1, (layers, h)) / math.sqrt(h)
    f = rng.standard_normal((layers, h)) * 15 + 30
    p = rng.standard_normal((layers, h))
    ws = [_pair(wi.astype(np.float32)) for wi in w]
    vecs = [_pair(v.astype(np.float32), jnp.float32) for v in (b, f, p)]
    return [w[0] for w in ws], [w[1] for w in ws], vecs


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


def _rel(a, b):
    return np.abs(_np(a) - _np(b)).max() / np.abs(_np(b)).max()


# the port's variant nearest to the JAX kernel's (tile, interleave): the
# wgmma kernel takes 64-row warpgroups, interleaved only on 128-row tiles
PORT_VARIANT = {(64, 1): (64, 1), (64, 2): (128, 2)}


@pytest.mark.parametrize("interleave", [1, 2])
def test_chain_matches_jax_kernel(interpret_pallas, interleave):
    (jx, tx), jws, tws = _chain_inputs(256, 64, jchain.LAYERS)
    ref = jchain.run_chain(jx, jws, tile=64, interleave=interleave)
    calls, launches = mc.chain_reference.calls, mc.run_chain.launches
    tile, k = PORT_VARIANT[(64, interleave)]
    out = mc.run_chain(tx, tws, tile=tile, interleave=k)
    assert (mc.chain_reference.calls, mc.run_chain.launches) == (
        calls + 1, launches)           # the CPU route is the plain version
    assert out.shape == (256, 64) and out.dtype == torch.bfloat16
    assert _rel(out, ref) <= CHAIN_TOL
    # neither tile nor interleave changes the result
    assert torch.equal(out, mc.run_chain(tx, torch.stack(tws), tile=128,
                                         interleave=1))


def test_wide_matches_jax_kernel(interpret_pallas):
    (jx, tx), jws, tws = _chain_inputs(256, 128, 5, seed=2)
    ref = jchain.run_wide(jx, jws, tile=128)
    out = mc.run_wide(tx, tws, tile=64)
    assert _rel(out, ref) <= CHAIN_TOL
    assert torch.equal(out, mc.run_chain(tx, tws))


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
def test_epi_matches_jax_kernel_on_the_script_draw(interpret_pallas,
                                                   monkeypatch, fold, layers):
    """The script's draw is chaotic from layer 3 on; held over 1-2."""
    monkeypatch.setattr(jepi, "LAYERS", layers)
    (jx, tx), _, _ = _chain_inputs(256, 64, 0, seed=3)
    jws, tws, vecs = _film_inputs(layers, 64, "script")
    ref = jepi.run_epi(jx, jws, *(v[0] for v in vecs), tile=64,
                       interleave=2, fold=fold)
    calls = mc.epi_reference.calls
    tile, k = PORT_VARIANT[(64, 2)]
    out = mc.run_epi(tx, tws, *(v[1] for v in vecs), tile=tile, interleave=k,
                     fold=fold)
    assert mc.epi_reference.calls == calls + 1
    assert np.abs(_np(out) - _np(ref)).max() <= EPI_TOL


@pytest.mark.parametrize("fold", [False, True])
def test_epi_matches_jax_kernel_at_the_field_scale(interpret_pallas, fold):
    """11 layers at the field's own weight scale stay bounded."""
    (jx, tx), _, _ = _chain_inputs(256, 64, 0, seed=4)
    jws, tws, vecs = _film_inputs(jepi.LAYERS, 64, "field")
    ref = jepi.run_epi(jx, jws, *(v[0] for v in vecs), tile=128, fold=fold)
    out = mc.run_epi(tx, tws, *(v[1] for v in vecs), tile=128, fold=fold)
    assert np.abs(_np(out) - _np(ref)).max() <= EPI_TOL
    assert np.abs(_np(out)).max() <= 1.0


def test_fold_forms_the_scaled_weights_in_bf16():
    """fold multiplies by the weights scaled in bf16, bf16(W * bf16(f)), as
    the JAX kernel forms them, and adds f * b + p in f32."""
    (_, tx), _, _ = _chain_inputs(64, 64, 0, seed=5)
    _, tws, vecs = _film_inputs(1, 64, "field")
    b, f, p = (v[1] for v in vecs)
    out = mc.epi_reference(tx, tws, b, f, p, fold=True)
    scaled = (tws[0].float() * f[0].bfloat16().float()).bfloat16().float()
    want = mc.fast_sin(tx.float() @ scaled + (f[0] * b[0] + p[0]))
    assert torch.equal(out, want.bfloat16())


def test_the_script_draw_is_chaotic_and_the_field_scale_is_not():
    """Why run_epi is held over 1-2 layers on the JAX script's draw and over
    11 at the field's weight scale (ROADMAP T14): the same chain with f64
    products parts from the f32 one by the whole range [-1, 1] at layer 4
    on the script's draw, and stays within a few bf16 steps at the field's
    scale."""
    from fenerf_tpu_torch.ops import probes

    gen = torch.Generator().manual_seed(0)
    x = probes.activations(gen, 2048, 256, "cpu")
    worst = {}
    for scale, layers in (("script", 4), ("field", 11)):
        w, b, f, p = probes.film_inputs(gen, layers, 256, "cpu", scale)
        a32 = a64 = x.float()
        for i in range(layers):
            y64 = (a64.double() @ w[i].double()).float()
            a32 = mc._bf16(mc.fast_sin(f[i] * (a32 @ w[i].float() + b[i])
                                       + p[i]))
            a64 = mc._bf16(mc.fast_sin(f[i] * (y64 + b[i]) + p[i]))
        worst[scale] = (a32 - a64).abs().max().item()
    assert worst["script"] > 1.0
    assert worst["field"] < 0.1


def _bad_inputs():
    x = torch.zeros(64, 64, dtype=torch.bfloat16)
    w = [torch.zeros(64, 64, dtype=torch.bfloat16)]
    v = torch.zeros(1, 64)
    wide = torch.zeros(8, 512, dtype=torch.bfloat16)
    return [
        ("x must", lambda: mc.run_chain(x.float(), w)),
        ("x must", lambda: mc.run_chain(x[:, ::2], w)),
        ("x must", lambda: mc.run_chain(x[:0], w)),
        ("width", lambda: mc.run_chain(torch.zeros(8, 96, dtype=torch.bfloat16),
                                       [torch.zeros(96, 96,
                                                    dtype=torch.bfloat16)])),
        ("ws must", lambda: mc.run_chain(x, [w[0].float()])),
        ("ws must", lambda: mc.run_chain(x, [torch.zeros(64, 32,
                                                         dtype=torch.bfloat16)])),
        ("tile", lambda: mc.run_chain(x, w, tile=256)),
        ("interleave", lambda: mc.run_chain(x, w, tile=64, interleave=4)),
        ("tile", lambda: mc.run_wide(
            wide, [torch.zeros(512, 512, dtype=torch.bfloat16)], tile=32)),
        # what the wgmma kernels do not take: 32-row tiles (run_wide's
        # too, above), a 4-way interleave, interleaved 64-row tiles, widths
        # above 256 (run_wide)
        ("tile", lambda: mc.run_chain(x, w, tile=32)),
        ("interleave", lambda: mc.run_chain(x, w, tile=128, interleave=4)),
        ("interleave", lambda: mc.run_epi(x, w, v, v, v, tile=64,
                                          interleave=2)),
        ("run_wide", lambda: mc.run_chain(
            wide, [torch.zeros(512, 512, dtype=torch.bfloat16)])),
        ("run_wide", lambda: mc.run_epi(
            wide, [torch.zeros(512, 512, dtype=torch.bfloat16)],
            *(torch.zeros(1, 512),) * 3)),
        ("weight stages", lambda: mc.run_epi(
            torch.zeros(8, 256, dtype=torch.bfloat16),
            torch.zeros(40, 256, 256, dtype=torch.bfloat16),
            *(torch.zeros(40, 256),) * 3)),
        ("tile", lambda: mc.run_wide(wide, [torch.zeros(
            512, 512, dtype=torch.bfloat16)], tile=256)),
        ("bs must", lambda: mc.run_epi(x, w, v.double(), v, v)),
        ("p must", lambda: mc.run_epi(x, w, v, v, torch.zeros(2, 64))),
    ]


@pytest.mark.parametrize("case", range(len(_bad_inputs())))
def test_wrappers_raise_on_what_the_kernel_does_not_take(case):
    match, call = _bad_inputs()[case]
    with pytest.raises(ValueError, match=match):
        call()


def test_chain_shared_memory_fits_every_probe_variant():
    """Both kernels' layouts. The chain (run_chain, run_epi): the probes'
    11 layers at width 256 fit a CTA's 227 KB with eight weight stages and
    both 64-row x tiles, for every epilogue (with the FiLM vectors,
    exactly). The wide chain (run_wide): at width 512 the two consumers'
    A tiles (128 KB) leave six 16 KB weight stages, one layout for both
    tiles (three stages per ring at tile 64)."""
    for epi in ("none", "film", "fold"):
        assert mc.chain_stages(256, 11, epi) == mc.MAX_STAGES
        assert mc.chain_smem(256, 11, epi) <= mc.MAX_SMEM
        for h in (64, 128, 192):
            assert mc.chain_smem(h, 11, epi) <= mc.chain_smem(256, 11, epi)
    assert mc.chain_smem(256, 11, "film") == mc.MAX_SMEM
    # more layers' FiLM vectors crowd the ring out; the wrapper raises
    # before the kernel would
    layers = next(n for n in range(12, 100)
                  if mc.chain_stages(256, n, "film") < mc.MIN_STAGES)
    assert mc.chain_smem(256, layers - 1, "film") <= mc.MAX_SMEM
    assert mc.wide_stages(512) == 6
    assert mc.wide_smem(512) == 2048 + 6 * 16384 + 2 * 64 * 512 * 2
    assert mc.wide_smem(512) <= mc.MAX_SMEM
    assert mc.wide_stages(512) // 2 >= 2      # tile 64: two rings
    for h in range(64, 512, 64):
        assert mc.wide_smem(h) <= mc.MAX_SMEM
        assert mc.wide_stages(h) >= mc.wide_stages(512)
