"""Port parity for the fused per-ray kernels (fenerf_tpu_torch/ops/
ray_finalize.py) against the JAX package's Pallas kernels
(fenerf_tpu/ops/ray_finalize.py) run in interpret mode, on the same
numpy-seeded inputs. On the CPU the port's wrappers run their plain versions,
which repeat the CUDA kernels' arithmetic (the card tests hold the kernels
to them). Also: the FENERF_RAY_KERNELS gate and a whole render through the
kernel route (forced on the CPU) against the JAX package's render on
replayed draws.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fenerf_tpu.models import generator as jgen
from fenerf_tpu.nn import fields as jfields
from fenerf_tpu.ops import ray_finalize as jrf
from fenerf_tpu_torch.compat.jax_bridge import from_numpy_tree
from fenerf_tpu_torch.core import integrate as tint
from fenerf_tpu_torch.models import generator as tgen
from fenerf_tpu_torch.nn import fields as tfields
from fenerf_tpu_torch.ops import ray_finalize as trf

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(t, a, atol, rtol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), atol=atol,
                               rtol=rtol)


def _finalize_data(seed=3, b=2, r=3, s=5, c1=5):
    """[fine | coarse] samples with ties: a fine z equal to a coarse z (fine
    sorts first) and two equal coarse z."""
    rng = np.random.default_rng(seed)
    cz = np.sort(rng.uniform(0.88, 1.12, (b, r, s)), -1).astype(np.float32)
    fz = rng.uniform(0.88, 1.12, (b, r, s)).astype(np.float32)
    fz[..., 2] = cz[..., 3]
    cz[..., 1] = cz[..., 2]
    fo = rng.standard_normal((b, r, s, c1)).astype(np.float32)
    co = rng.standard_normal((b, r, s, c1)).astype(np.float32)
    fo[..., -1] *= 10.0
    co[..., -1] *= 10.0
    noise = rng.standard_normal((b, r, 2 * s)).astype(np.float32)
    return fo, co, fz, cz, noise


@pytest.mark.parametrize("clamp", ["relu", "softplus"])
@pytest.mark.parametrize("noisy", [True, False])
def test_ray_resample_matches_jax(clamp, noisy):
    rng = np.random.default_rng(0)
    b, r, s = 2, 7, 6
    sig = (rng.standard_normal((b, r, s)) * 10).astype(np.float32)
    z = np.sort(rng.uniform(0.88, 1.12, (b, r, s)), -1).astype(np.float32)
    nz = (rng.standard_normal((b, r, s)) * 0.3).astype(np.float32) \
        if noisy else None
    u = rng.uniform(0, 1, (b, r, s)).astype(np.float32)
    j = lambda x: None if x is None else jnp.asarray(x)
    t = lambda x: None if x is None else _t(x)
    ref = jrf.ray_resample(j(sig), j(z), j(nz), j(u), clamp_mode=clamp,
                           interpret=True)
    calls = trf.ray_resample_reference.calls
    got = trf.ray_resample(t(sig), t(z), t(nz), t(u), clamp_mode=clamp)
    assert trf.ray_resample_reference.calls == calls + 1
    assert trf.ray_resample.launches == 0   # no kernel on the CPU
    _close(got, ref, 1e-5)
    # and the torch route it replaces (integrate_weights + sample_pdf)
    w = tint.integrate_weights(t(sig), t(z), noise=t(nz), noise_std=1.0,
                               clamp_mode=clamp) + 1e-5
    _close(got, tint.sample_pdf(tint.midpoints(t(z)), w[..., 1:-1], s,
                                u=t(u)).numpy(), 1e-5)


FINALIZE_KW = [
    dict(),
    dict(last_back=True),
    dict(white_back=True),
    dict(black_back=True),
    dict(clamp_mode="softplus"),
    dict(fill_mode="seg_padding_background", fill_color="light_grey"),
    dict(fill_mode="eval_white_back"),
    dict(fill_mode="debug"),
    dict(fill_mode="seg_padding_background", softmax_label=True, rgb_dim=3),
]


@pytest.mark.parametrize("noisy", [True, False])
@pytest.mark.parametrize("kw", FINALIZE_KW, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_ray_finalize_matches_jax(kw, noisy):
    fo, co, fz, cz, noise = _finalize_data()
    nz = noise if noisy else None
    ref = jrf.ray_finalize(*map(jnp.asarray, (fo, co, fz, cz)),
                           None if nz is None else jnp.asarray(nz),
                           interpret=True, **kw)
    got = trf.ray_finalize(_t(fo), _t(co), _t(fz), _t(cz),
                           None if nz is None else _t(nz), **kw)
    for g, a in zip(got, ref):
        assert tuple(g.shape) == tuple(a.shape)
        _close(g, a, 2e-5)


def test_ray_finalize_vjp_matches_jax_grads():
    fo, co, fz, cz, noise = _finalize_data(seed=9)
    kw = dict(fill_mode="seg_padding_background", clamp_mode="relu")

    def loss_jax(fo, co):
        c, d, w = jrf.ray_finalize_vjp(fo, co, jnp.asarray(fz),
                                       jnp.asarray(cz), jnp.asarray(noise),
                                       interpret=True, **kw)
        return (c ** 2).sum() + (d * 0.3).sum() + w.sum()

    gj = jax.jit(jax.grad(loss_jax, argnums=(0, 1)))(jnp.asarray(fo),
                                                     jnp.asarray(co))
    tfo, tco = _t(fo).requires_grad_(), _t(co).requires_grad_()
    c, d, w = trf.ray_finalize_vjp(tfo, tco, _t(fz), _t(cz), _t(noise), **kw)
    loss = (c ** 2).sum() + (d * 0.3).sum() + w.sum()
    gt = torch.autograd.grad(loss, (tfo, tco))
    for a, b in zip(gt, gj):
        _close(a, b, 3e-4, 1e-3)


def test_ray_finalize_vjp_noise_free_is_the_torch_route_gradient():
    """The noise-free variant (static renders, the inversion loop): finite
    gradients, equal to autograd through the torch route it recomputes."""
    fo, co, fz, cz, _ = _finalize_data(seed=4)
    tfo = _t(fo).requires_grad_()
    c, d, w = trf.ray_finalize_vjp(tfo, _t(co), _t(fz), _t(cz), None)
    (g,) = torch.autograd.grad((c ** 2).sum() + d.sum(), tfo)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    res = tint.composite_merged_nosort(tfo, _t(co), _t(fz), _t(cz))
    (g_ref,) = torch.autograd.grad((res.comp ** 2).sum() + res.depth.sum(),
                                   tfo)
    torch.testing.assert_close(g, g_ref, atol=1e-6, rtol=1e-6)


def _register_prefix_sum(x: np.ndarray, exclusive: bool) -> np.ndarray:
    """numpy f32 emulation of ops/csrc/ray_finalize.cu::prefix_sum: sample
    i of a warp's ray in lane i % 32, slot i / 32 (the slots past the last
    sample hold zeros); a step sh < 32 shuffles every slot from lane
    (l - sh) & 31 and a lane l < sh takes the previous slot's value (zero
    below slot 0); a step sh >= 32 adds the slot sh / 32 below (zero below
    slot 0); exclusive shifts by one lane the same way."""
    n = x.shape[-1]
    slots = -(-n // 32)
    v = np.zeros(x.shape[:-1] + (slots, 32), np.float32)
    v.reshape(x.shape[:-1] + (32 * slots,))[..., :n] = x
    lane = np.arange(32)

    def lane_shift(v, sh):
        a = v[..., (lane - sh) & 31]   # the shuffle of each slot
        prev = np.concatenate([np.zeros_like(a[..., :1, :]), a[..., :-1, :]],
                              axis=-2)  # the previous slot's shuffle
        return np.where(lane >= sh, a, prev)

    sh = 1
    while sh < n:
        if sh < 32:
            v = v + lane_shift(v, sh)
        else:
            ks = sh // 32
            below = np.concatenate([np.zeros_like(v[..., :ks, :]),
                                    v[..., :-ks, :]], axis=-2)
            v = v + below
        sh *= 2
    if exclusive:
        v = lane_shift(v, 1)
    assert v.dtype == np.float32
    return v.reshape(x.shape[:-1] + (32 * slots,))[..., :n]


@pytest.mark.parametrize("s", [3, 5, 24, 37, 48, 96, 256])
@pytest.mark.parametrize("exclusive", [False, True])
def test_register_prefix_sum_is_the_plain_order(s, exclusive):
    """The kernels' register formulation of the lane-doubling sum adds the
    same terms in the same order as the plain versions' _prefix_sum: bit
    for bit, on log(1 - alpha)-like and weight-like rows."""
    rng = np.random.default_rng(s)
    x = np.concatenate([
        np.log(rng.uniform(1e-3, 1.0, (64, s))),
        rng.uniform(0.0, 1.0, (64, s)) * rng.uniform(1e-6, 1e3, (64, 1)),
    ]).astype(np.float32)
    got = _register_prefix_sum(x, exclusive)
    want = trf._prefix_sum(torch.from_numpy(x), exclusive=exclusive).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_gate(monkeypatch):
    rcfg = tgen.RenderConfig(num_steps=6, backend="kernel")
    monkeypatch.delenv("FENERF_RAY_KERNELS", raising=False)
    assert tgen.ray_route(rcfg, "cuda")[0] == "torch"      # default never
    monkeypatch.setenv("FENERF_RAY_KERNELS", "auto")
    assert tgen.ray_route(rcfg, "cpu")[0] == "torch"       # auto: CUDA only
    assert tgen.ray_route(rcfg, "cuda")[0] == "kernels"
    assert tgen.ray_route(rcfg.__class__(num_steps=6, backend="kernel_train"),
                          "cuda")[0] == "kernels"
    route, why = tgen.ray_route(tgen.RenderConfig(num_steps=2,
                                                  backend="kernel"), "cuda")
    assert route == "torch" and "< 3" in why
    assert tgen.ray_route(tgen.RenderConfig(num_steps=6, backend="torch"),
                          "cuda")[0] == "torch"
    for mode in ("always", "sometimes"):
        monkeypatch.setenv("FENERF_RAY_KERNELS", mode)
        with pytest.raises(ValueError, match="FENERF_RAY_KERNELS"):
            tgen.ray_route(rcfg, "cpu")


def _kernel_route_on_cpu(monkeypatch):
    """Send _shade_rays down the kernel route on the CPU, where the
    wrappers run their plain versions (the gate itself opens on CUDA
    only)."""
    monkeypatch.setattr(tgen, "ray_route",
                        lambda rcfg, device: ("kernels", "test"))


# the JAX package's own kernel-route render test field (no texture grid)
FIELD = "SIRENBASELINESEMANTICDISENTANGLE"
SMALL = dict(hidden_dim=32, z_geo_dim=8, z_app_dim=8, map_hidden_dim=32)
RENDER = dict(img_size=8, num_steps=6, hierarchical=True, perturb=True,
              fill_mode="seg_padding_background", sample_dist="gaussian")


def _jax_draws(key, b, rcfg, noise_std):
    """The draws JAX render_core makes from `key`, as port RenderDraws."""
    def draw(key):
        k_rays, k_c, k_pdf, k_f = jax.random.split(key, 4)
        k_perturb, k_cam = jax.random.split(k_rays)
        k_h, k_v, _ = jax.random.split(k_cam, 3)
        return (jax.random.uniform(k_perturb,
                                   (b, rcfg.n_rays, rcfg.num_steps)),
                jax.random.normal(k_h, (b, 1)), jax.random.normal(k_v, (b, 1)),
                jgen.draw_ray_noise(k_c, k_pdf, k_f, b, rcfg.n_rays, rcfg,
                                    noise_std))

    jitter, cam_h, cam_v, noise = jax.jit(draw)(key)
    opt = lambda x: None if x is None else _t(x)
    return tgen.RenderDraws(jitter=_t(jitter), cam_h=_t(cam_h),
                            cam_v=_t(cam_v),
                            noise=tgen.RayNoise(*(opt(x) for x in noise)))


@functools.lru_cache(maxsize=1)
def _small_models():
    jcfg = jfields.get_config(FIELD, **SMALL)
    tcfg = tfields.get_config(FIELD, **SMALL)
    jp = jax.jit(lambda k: jfields.init_field(k, jcfg))(jax.random.key(0))
    jp["sigma_head"]["b"] = jp["sigma_head"]["b"] + 5.0   # a dense volume
    return jcfg, tcfg, jp, from_numpy_tree(jax.tree.map(np.asarray, jp))


def test_render_through_ray_kernels_matches_jax(monkeypatch):
    """A whole hierarchical render through the kernel route against the
    JAX package's render (its XLA route) on replayed draws. The field
    runs on the f32 torch route, so the only differences are the ray
    kernels' formulation and f32 summation order, amplified through the
    resampled fine positions."""
    jcfg, tcfg, jp, tp = _small_models()
    rng = np.random.default_rng(5)
    zg = rng.standard_normal((2, 8)).astype(np.float32)
    za = rng.standard_normal((2, 8)).astype(np.float32)
    key = jax.random.key(7)
    jr = jgen.RenderConfig(**RENDER)
    ref = jax.jit(lambda p, zg, za: jgen.render_from_z(
        p, jcfg, jr, key, zg, za, noise_std=0.5))(jp, jnp.asarray(zg),
                                                  jnp.asarray(za))
    _kernel_route_on_cpu(monkeypatch)
    calls = (trf.ray_resample_reference.calls,
             trf.ray_finalize_reference.calls)
    out = tgen.render_from_z(tp, tcfg, tgen.RenderConfig(**RENDER,
                                                         backend="torch"),
                             _t(zg), _t(za), noise_std=0.5,
                             draws=_jax_draws(key, 2, jr, 0.5))
    assert (trf.ray_resample_reference.calls,
            trf.ray_finalize_reference.calls) == (calls[0] + 1, calls[1] + 1)
    assert float(np.asarray(ref["opacity"]).mean()) > 0.5   # non-empty
    for k in ("pixels", "depth", "opacity"):
        _close(out[k], ref[k], 1e-3)


def test_ray_kernel_route_chunked_equals_whole(monkeypatch):
    """ray_chunk against the whole image through the kernel route (the
    fused field's and the ray kernels' plain versions on the CPU); the
    `never` route counts no ray-kernel call."""
    _, tcfg, _, tp = _small_models()
    fg, fa = tfields.field_film(tp, tcfg, torch.ones(1, 8) * 0.3,
                                torch.ones(1, 8) * -0.2)

    def render(chunk):
        rcfg = tgen.RenderConfig(**RENDER, ray_chunk=chunk, backend="kernel")
        return tgen.render(tp, tcfg, rcfg, fg, fa, 1, noise_std=0.5,
                           generator=torch.Generator().manual_seed(3))

    counts = lambda: (trf.ray_resample_reference.calls,
                      trf.ray_finalize_reference.calls,
                      trf.ray_resample.launches, trf.ray_finalize.launches)
    monkeypatch.setenv("FENERF_RAY_KERNELS", "never")
    before = counts()
    torch_route = render(16)["pixels"]
    assert counts() == before
    _kernel_route_on_cpu(monkeypatch)
    chunked = render(16)
    assert counts() == (before[0] + 4, before[1] + 4, 0, 0)
    whole = render(0)
    # CPU gemms may round by tile shape; the card is held to equality
    torch.testing.assert_close(chunked["pixels"], whole["pixels"], atol=1e-5,
                               rtol=0)
    assert torch.isfinite(chunked["pixels"]).all()
    torch.testing.assert_close(chunked["pixels"], torch_route, atol=1e-3,
                               rtol=0)
