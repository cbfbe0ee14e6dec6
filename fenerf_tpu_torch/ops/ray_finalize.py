"""Fused per-ray hierarchical-rendering kernels: the Python side of the CUDA
kernels (port of the Pallas kernels fenerf_tpu/ops/ray_finalize.py::
ray_resample and ray_finalize, with ray_finalize_vjp).

  ray_resample   coarse sigma (+ pre-scaled noise) -> proposal weights ->
                 inverse-CDF importance resample at the given uniforms ->
                 fine z.
  ray_finalize   [fine | coarse] outputs and z -> stable depth ranks ->
                 sorted-order compositing -> optional fill and label-softmax
                 epilogue -> (comp, depth, weights_sum).

Both follow the TPU kernels' formulation, which the plain versions
(`ray_resample_reference`, `ray_finalize_reference`) repeat operation for
operation: transmittance as exp of an exclusive prefix sum of
log(1 - alpha + 1e-10) (over sample order in ray_resample, over depth rank
in ray_finalize), every prefix sum in the TPU kernel's lane-doubling
(Hillis-Steele) order, the proposal weights' double epsilon added as
(w + 1e-5) + 1e-5, denominators below 1e-5 replaced by 1, and pick indices
clamped to [0, M-1]. The same additions in the same order make kernel and
plain version agree to the rounding of exp / log and the compositing sum.

Dispatch: a wrapper runs its plain version for CPU tensors and the CUDA
kernel (ops/csrc/ray_finalize.cu) for CUDA tensors, or raises; it never
falls back. `ray_finalize_vjp` is differentiable: its forward is
ray_finalize, its backward recomputes through the port's torch route
(core/integrate.py::composite_merged_nosort plus the epilogue) and
differentiates that, as the JAX package's custom VJP does (the TPU kernel
has no backward kernel either).
"""
from __future__ import annotations

import ctypes

import torch

from fenerf_tpu_torch.core import integrate as integ
from fenerf_tpu_torch.ops import build

# the kernels keep a ray's samples in registers and shared memory
MAX_SAMPLES = 256   # ray_resample: S; ray_finalize: S_fine + S_coarse
MAX_CHANNELS = 128  # ray_finalize: output channels after the epilogue

_CLAMP = {"relu": 0, "softplus": 1}
# fill epilogues (ops/csrc/ray_finalize.cu), from integ.apply_fill
_FILL = {None: 0, "weight": 0, "seg_padding_background": 1,
         "eval_seg_padding_background": 1, "eval_white_back": 2, "debug": 3,
         "weight_debug": 3}


def _prefix_sum(x: torch.Tensor, exclusive: bool = False) -> torch.Tensor:
    """Prefix sum along the last axis in the TPU kernel's lane-doubling
    order: x[i] += x[i - sh] for sh = 1, 2, 4, ... (then shifted by one for
    the exclusive sum). The CUDA kernels add in the same order."""
    width = x.shape[-1]
    pad = lambda t, sh: torch.nn.functional.pad(t[..., :width - sh], (sh, 0))
    sh = 1
    while sh < width:
        x = x + pad(x, sh)
        sh *= 2
    return pad(x, 1) if exclusive else x


def _deltas_last_1e10(z: torch.Tensor) -> torch.Tensor:
    return torch.cat([z[..., 1:] - z[..., :-1],
                      torch.full_like(z[..., :1], 1e10)], dim=-1)


# ---------------------------------------------------------------------------
# proposal + importance resampling
# ---------------------------------------------------------------------------

def ray_resample_reference(sigma: torch.Tensor, z_vals: torch.Tensor,
                           noise: torch.Tensor | None, u: torch.Tensor,
                           clamp_mode: str = "relu") -> torch.Tensor:
    """The plain torch version of the resample kernel. sigma, z_vals,
    noise (B, R, S), z sorted, noise PRE-scaled or None; u (B, R, n_imp)
    -> fine z (B, R, n_imp). Same semantics as integrate_weights (+1e-5)
    then sample_pdf over the midpoints and the interior weights."""
    ray_resample_reference.calls += 1
    s = sigma.shape[-1]
    m = s - 1                                   # bins (midpoints)
    if noise is not None:
        sigma = sigma + noise
    act = integ._act_sigma(sigma, clamp_mode)
    alphas = 1.0 - torch.exp(-_deltas_last_1e10(z_vals) * act)
    trans = torch.exp(_prefix_sum(torch.log(1.0 - alphas + 1e-10),
                                  exclusive=True))
    w = alphas * trans
    # interior proposal weights at positions 1..S-2 of an S-wide row: pdf_j
    # sits at position j + 1, so the inclusive prefix at k is cdf_k
    wm = torch.nn.functional.pad((w[..., 1:-1] + 1e-5) + 1e-5, (1, 1))
    pdf = wm / _prefix_sum(wm)[..., -1:]
    cdf = _prefix_sum(pdf)[..., :m]
    bins = 0.5 * (z_vals[..., :-1] + z_vals[..., 1:])
    inds = (cdf[..., None, :] < u[..., :, None]).sum(-1)
    below = (inds - 1).clamp(0, m - 1)
    above = inds.clamp(0, m - 1)
    cdf_b, cdf_a = cdf.gather(-1, below), cdf.gather(-1, above)
    bins_b, bins_a = bins.gather(-1, below), bins.gather(-1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


ray_resample_reference.calls = 0


# ---------------------------------------------------------------------------
# merge + final integrate + fill (+ softmax) epilogue
# ---------------------------------------------------------------------------

def _fill_softmax_epilogue(comp, wsum, fill_mode, fill_color, softmax_label,
                           rgb_dim):
    """integ.apply_fill, then the optional per-ray label softmax over the
    channels before the last rgb_dim."""
    comp = integ.apply_fill(comp, wsum, fill_mode, fill_color)
    if softmax_label:
        seg, rgb = comp[..., :-rgb_dim], comp[..., -rgb_dim:]
        comp = torch.cat([torch.softmax(seg, dim=-1), rgb], dim=-1)
    return comp


def filled_channels(c: int, fill_mode: str | None) -> int:
    """Output channel count after the fill epilogue (seg padding adds a
    background-label channel, integrate.apply_fill)."""
    pads = fill_mode in ("seg_padding_background",
                         "eval_seg_padding_background")
    return c + 1 if pads else c


def ray_finalize_reference(fine_out, coarse_out, fine_z, coarse_z, noise,
                           clamp_mode="relu", last_back=False,
                           white_back=False, black_back=False,
                           fill_mode=None, fill_color="black",
                           softmax_label=False, rgb_dim=3):
    """The plain torch version of the finalize kernel. fine_out
    (B, R, S_f, C+1), coarse_out (B, R, S_c, C+1), fine_z (B, R, S_f)
    unsorted, coarse_z (B, R, S_c), noise (B, R, S_f+S_c) PRE-scaled and
    indexed by sorted position, or None -> (comp (B, R, C_out), depth
    (B, R), weights_sum (B, R))."""
    ray_finalize_reference.calls += 1
    s = fine_z.shape[-1] + coarse_z.shape[-1]
    all_z = torch.cat([fine_z, coarse_z], dim=-1)
    all_out = torch.cat([fine_out, coarse_out], dim=-2)
    rank = integ._before_mask(all_z).sum(-1)
    # delta: z of the rank successor minus own z (one nonzero term: exact)
    nxt = rank[..., None, :] == rank[..., :, None] + 1
    next_z = torch.where(nxt, all_z[..., None, :],
                         torch.zeros_like(all_z[..., None, :])).sum(-1)
    deltas = torch.where(rank == s - 1, torch.full_like(all_z, 1e10),
                         next_z - all_z)
    sigma = all_out[..., -1]
    if noise is not None:
        sigma = sigma + noise.gather(-1, rank)
    alphas = 1.0 - torch.exp(-deltas * integ._act_sigma(sigma, clamp_mode))
    # transmittance: exclusive prefix sum of log(1 - alpha) in depth order
    log_om = torch.log(1.0 - alphas + 1e-10)
    by_rank = torch.zeros_like(log_om).scatter(-1, rank, log_om)
    w = alphas * torch.exp(_prefix_sum(by_rank, exclusive=True).gather(
        -1, rank))
    wsum = w.sum(-1)
    if last_back:
        w = w + torch.where(rank == s - 1, (1.0 - wsum)[..., None],
                            torch.zeros_like(w))
    comp = torch.sum(w[..., None] * all_out[..., :-1], dim=-2)
    depth = torch.sum(w * all_z, dim=-1)
    if white_back:
        comp = comp + (1.0 - wsum)[..., None]
    if black_back:
        comp = comp - (1.0 - wsum)[..., None]
    comp = _fill_softmax_epilogue(comp, wsum, fill_mode, fill_color,
                                  softmax_label, rgb_dim)
    return comp, depth, wsum


ray_finalize_reference.calls = 0


def _finalize_torch(fine_out, coarse_out, fine_z, coarse_z, noise, *,
                    clamp_mode, last_back, white_back, black_back, fill_mode,
                    fill_color, softmax_label, rgb_dim):
    """The same function through the port's torch route (noise PRE-scaled:
    noise_std 1.0): ray_finalize_vjp's backward recomputes through it."""
    res = integ.composite_merged_nosort(
        fine_out, coarse_out, fine_z, coarse_z, noise=noise, noise_std=1.0,
        clamp_mode=clamp_mode, last_back=last_back, white_back=white_back,
        black_back=black_back)
    comp = _fill_softmax_epilogue(res.comp, res.weights_sum, fill_mode,
                                  fill_color, softmax_label, rgb_dim)
    return comp, res.depth, res.weights_sum


class RayFinalizeVJP(torch.autograd.Function):
    """ray_finalize forward, torch-route backward. Saves only its inputs;
    the backward recomputes the merge under enable_grad and returns the
    cotangents of the inputs that need them. `noise` may be None (the
    noise-free variant: static renders, the inversion loop)."""

    @staticmethod
    def forward(ctx, fine_out, coarse_out, fine_z, coarse_z, noise, static):
        ctx.static = static
        ctx.save_for_backward(fine_out, coarse_out, fine_z, coarse_z, noise)
        return ray_finalize(fine_out, coarse_out, fine_z, coarse_z, noise,
                            **static)

    @staticmethod
    def backward(ctx, g_comp, g_depth, g_wsum):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(saved, need)]
            outs = _finalize_torch(*leaves, **ctx.static)
            wrt = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(
                outs, wrt, (g_comp, g_depth, g_wsum), allow_unused=True))
        return tuple(next(grads) if n else None for n in need) + (None,)


def ray_finalize_vjp(fine_out, coarse_out, fine_z, coarse_z, noise, *,
                     clamp_mode="relu", last_back=False, white_back=False,
                     black_back=False, fill_mode=None, fill_color="black",
                     softmax_label=False, rgb_dim=3):
    """ray_finalize with a training-grade backward (RayFinalizeVJP): equal
    values up to f32 rounding order; the gradient is the exact gradient of
    the torch-route math."""
    static = dict(clamp_mode=clamp_mode, last_back=last_back,
                  white_back=white_back, black_back=black_back,
                  fill_mode=fill_mode, fill_color=fill_color,
                  softmax_label=softmax_label, rgb_dim=rgb_dim)
    return RayFinalizeVJP.apply(fine_out, coarse_out, fine_z, coarse_z,
                                noise, static)


# ---------------------------------------------------------------------------
# The CUDA kernels: built with nvcc at first use (ops/build.py), bound with
# ctypes
# ---------------------------------------------------------------------------

_LIB = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ray_finalize.cu."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ray_resample_forward.argtypes = [vp] * 5 + [ci] * 4 + [vp]
    lib.ray_resample_forward.restype = ci
    lib.ray_finalize_forward.argtypes = (
        [vp] * 8 + [ci] * 9 + [cf] + [ci] * 3 + [vp])
    lib.ray_finalize_forward.restype = ci
    lib.ray_finalize_error_string.argtypes = [ci]
    lib.ray_finalize_error_string.restype = ctypes.c_char_p
    return lib


def _load_library():
    """ops/csrc/ray_finalize.cu, built for sm_90a into build/ and loaded."""
    global _LIB
    if _LIB is None:
        _LIB = bind(build.library("ray_finalize"))
    return _LIB


def _check(t, who, name, shape, device):
    if t.device != device or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{who}: {name} must be a contiguous float32 tensor of shape "
            f"{tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def _raise_on(lib, rc, who):
    if rc != 0:
        msg = lib.ray_finalize_error_string(rc).decode()
        raise RuntimeError(f"{who} kernel launch failed: {msg} ({rc})")


def ray_resample(sigma: torch.Tensor, z_vals: torch.Tensor,
                 noise: torch.Tensor | None, u: torch.Tensor,
                 clamp_mode: str = "relu") -> torch.Tensor:
    """(B, R, S) coarse sigma (the caller detaches it), sorted z, PRE-scaled
    noise or None; (B, R, n_imp) uniforms -> (B, R, n_imp) fine z.

    CPU tensors take ray_resample_reference; CUDA tensors launch the sm_90a
    kernel (ops/csrc/ray_finalize.cu) or raise."""
    if sigma.device.type == "cpu":
        return ray_resample_reference(sigma, z_vals, noise, u, clamp_mode)
    if sigma.device.type != "cuda":
        raise ValueError(f"ray_resample: no kernel for device {sigma.device}")
    if clamp_mode not in _CLAMP:
        raise ValueError(f"unknown clamp_mode {clamp_mode!r}")
    dev = sigma.device
    b, r, s = sigma.shape
    n_imp = u.shape[-1]
    if not 3 <= s <= MAX_SAMPLES:
        raise ValueError(f"ray_resample: S={s} outside [3, {MAX_SAMPLES}]")
    who = "ray_resample"
    _check(sigma, who, "sigma", (b, r, s), dev)
    _check(z_vals, who, "z_vals", (b, r, s), dev)
    _check(u, who, "u", (b, r, n_imp), dev)
    if noise is not None:
        _check(noise, who, "noise", (b, r, s), dev)
    out = torch.empty(b, r, n_imp, dtype=torch.float32, device=dev)
    rows = b * r
    if rows == 0 or n_imp == 0:
        return out
    lib = _load_library()
    rc = lib.ray_resample_forward(
        sigma.data_ptr(), z_vals.data_ptr(),
        None if noise is None else noise.data_ptr(), u.data_ptr(),
        out.data_ptr(), rows, s, n_imp, _CLAMP[clamp_mode],
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, who)
    ray_resample.launches += 1
    return out


ray_resample.launches = 0


def ray_finalize(fine_out, coarse_out, fine_z, coarse_z, noise,
                 clamp_mode="relu", last_back=False, white_back=False,
                 black_back=False, fill_mode=None, fill_color="black",
                 softmax_label=False, rgb_dim=3):
    """-> (comp (B, R, C_out), depth (B, R), weights_sum (B, R)); shapes as
    ray_finalize_reference. Not differentiable: see ray_finalize_vjp.

    CPU tensors take ray_finalize_reference; CUDA tensors launch the sm_90a
    kernel (ops/csrc/ray_finalize.cu) or raise."""
    static = dict(clamp_mode=clamp_mode, last_back=last_back,
                  white_back=white_back, black_back=black_back,
                  fill_mode=fill_mode, fill_color=fill_color,
                  softmax_label=softmax_label, rgb_dim=rgb_dim)
    if fine_out.device.type == "cpu":
        return ray_finalize_reference(fine_out, coarse_out, fine_z,
                                      coarse_z, noise, **static)
    if fine_out.device.type != "cuda":
        raise ValueError(
            f"ray_finalize: no kernel for device {fine_out.device}")
    if clamp_mode not in _CLAMP:
        raise ValueError(f"unknown clamp_mode {clamp_mode!r}")
    if fill_mode not in _FILL:
        raise ValueError(f"unknown fill_mode {fill_mode!r}")
    dev = fine_out.device
    b, r, sf, c1 = fine_out.shape
    sc = coarse_out.shape[2]
    c_out = filled_channels(c1 - 1, fill_mode)
    who = "ray_finalize"
    if not 2 <= sf + sc <= MAX_SAMPLES or sf < 1 or sc < 1:
        raise ValueError(f"ray_finalize: S_f={sf}, S_c={sc}: need both >= 1 "
                         f"and S_f + S_c <= {MAX_SAMPLES}")
    if not 1 <= c_out <= MAX_CHANNELS or (softmax_label
                                          and not 0 < rgb_dim < c_out):
        raise ValueError(f"ray_finalize: {c_out} output channels "
                         f"(rgb_dim {rgb_dim}) not covered")
    _check(fine_out, who, "fine_out", (b, r, sf, c1), dev)
    _check(coarse_out, who, "coarse_out", (b, r, sc, c1), dev)
    _check(fine_z, who, "fine_z", (b, r, sf), dev)
    _check(coarse_z, who, "coarse_z", (b, r, sc), dev)
    if noise is not None:
        _check(noise, who, "noise", (b, r, sf + sc), dev)
    e = lambda *shape: torch.empty(*shape, dtype=torch.float32, device=dev)
    comp, depth, wsum = e(b, r, c_out), e(b, r), e(b, r)
    rows = b * r
    if rows == 0:
        return comp, depth, wsum
    lib = _load_library()
    rc = lib.ray_finalize_forward(
        fine_out.data_ptr(), coarse_out.data_ptr(), fine_z.data_ptr(),
        coarse_z.data_ptr(), None if noise is None else noise.data_ptr(),
        comp.data_ptr(), depth.data_ptr(), wsum.data_ptr(), rows, sf, sc,
        c1, _CLAMP[clamp_mode], int(last_back), int(white_back),
        int(black_back), _FILL[fill_mode], integ._FILL_VALUES[fill_color],
        int(softmax_label), rgb_dim, c_out,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, who)
    ray_finalize.launches += 1
    return comp, depth, wsum


ray_finalize.launches = 0
