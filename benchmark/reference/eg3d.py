"""Plain EG3D tri-plane generator (NVlabs/eg3d: training/triplane.py
TriPlaneGenerator, training/networks_stylegan2.py, training/
superresolution.py SuperresolutionHybrid8XDC, training/volumetric_rendering
renderer.py ImportanceRenderer, ray_marcher.py MipRayMarcher2,
ray_sampler.py RaySampler, camera_utils.py LookAtPoseSampler), written from
the published code in float32 on a state_dict with EG3D's names and
layouts (linears (out, in), convolutions OIHW).

  mapping    normalize_2nd_moment(z) | normalize_2nd_moment(embed(c)),
             `map_depth` FC layers at lr 0.01, lrelu x sqrt 2
  synthesis  StyleGAN2 skip blocks: per-sample modulated weights (the fused
             modconv of inference: grouped convolutions), demodulated, the
             2x up path as a stride-2 transposed convolution then the
             [1, 3, 3, 1] filter (pad 1, gain 4), noise (const x strength)
             before bias and lrelu; ToRGB undemodulated, styles x
             1 / sqrt(fan_in); the skip image upsampled (pad (2, 1), gain 4)
  renderer   RaySampler rays, sample_stratified, sample_from_planes (the
             points x 2 / box_warp times the inverse plane axes by a batched
             product), OSGDecoder, MipRayMarcher2, sample_importance (weights
             max-pooled, avg-pooled, + 0.01; sample_pdf with
             searchsorted(right=True) over the midpoints with weights
             [1:-1]), unify_samples (sort, gather), the marcher again
  superres   block0 (32 -> 256 at 256^2), block1 (-> 128 at 512^2),
             noise mode 'none'

Departures: the rays are rendered in blocks of `ray_chunk` rays (EG3D
renders a batch's rays in one call), so MipRayMarcher2's clamp of the depth
takes the block's least and greatest depth; it reaches the depth only where
a ray's weights sum to 0. Products follow `Products` (benchmark/reference/
precision.py): `mapping` the mapping, synthesis and super-resolution (their
convolutions' operands rounded to it), `field` the plane projection,
`heads` the decoder, `table` the planes' features as sampled.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from benchmark.reference.precision import EXACT, Products, matmul, round_to

FILTER = (1.0, 3.0, 3.0, 1.0)
PLANE_AXES = ((1, 0, 0, 0, 1, 0, 0, 0, 1), (1, 0, 0, 0, 0, 1, 0, 1, 0),
              (0, 0, 1, 1, 0, 0, 0, 1, 0))


class Sizes(NamedTuple):
    z_dim: int = 512
    c_dim: int = 25
    w_dim: int = 512
    map_depth: int = 2
    plane_res: int = 256
    plane_ch: int = 32
    channel_base: int = 32768
    channel_max: int = 512
    decoder_hidden: int = 64
    sr_in: int = 128
    sr_channels: tuple = (256, 128)
    box_warp: float = 1.0


class RenderSpec(NamedTuple):
    img_size: int = 128
    num_steps: int = 48          # stratified; as many importance samples
    ray_start: float = 2.25
    ray_end: float = 3.3
    ray_chunk: int = 4096


def channels(s: Sizes) -> dict:
    res = [2 ** i for i in range(2, int(math.log2(s.plane_res)) + 1)]
    return {r: min(s.channel_base // r, s.channel_max) for r in res}


def init_state(gen: torch.Generator, s: Sizes, device="cpu",
               noise_std: float = 0.0) -> dict:
    """A TriPlaneGenerator state_dict with EG3D's initialisations (weights
    N(0, 1) / lr, biases 0, the affines' biases 1); the noise strengths
    N(0, noise_std^2) where EG3D starts them at 0."""
    sd = {}
    rn = lambda *shape: torch.randn(shape, generator=gen, device=device)

    def fc(name, i, o, lr=1.0, bias=0.0):
        sd[f"{name}.weight"] = rn(o, i) / lr
        sd[f"{name}.bias"] = torch.full((o,), bias, device=device)

    def conv(name, i, o, res, k=3, noise=True):
        sd[f"{name}.weight"] = rn(o, i, k, k)
        sd[f"{name}.bias"] = torch.zeros((o,), device=device)
        fc(f"{name}.affine", s.w_dim, i, bias=1.0)
        if noise:
            sd[f"{name}.noise_const"] = rn(res, res)
            sd[f"{name}.noise_strength"] = rn() * noise_std

    def block(name, i, o, res, img_ch):
        if i == 0:
            sd[f"{name}.const"] = rn(o, res, res)
        else:
            conv(f"{name}.conv0", i, o, res)
        conv(f"{name}.conv1", o, o, res)
        conv(f"{name}.torgb", o, img_ch, res, k=1, noise=False)

    m = "backbone.mapping"
    fc(f"{m}.embed", s.c_dim, s.w_dim)
    for i in range(s.map_depth):
        fc(f"{m}.fc{i}", s.z_dim + s.w_dim if i == 0 else s.w_dim, s.w_dim,
           lr=0.01)
    sd[f"{m}.w_avg"] = torch.zeros((s.w_dim,), device=device)
    ch = channels(s)
    for r, c in ch.items():
        block(f"backbone.synthesis.b{r}", ch.get(r // 2, 0), c, r,
              3 * s.plane_ch)
    fc("decoder.net.0", s.plane_ch, s.decoder_hidden)
    fc("decoder.net.2", s.decoder_hidden, 1 + s.plane_ch)
    i = s.plane_ch
    for k, o in enumerate(s.sr_channels):
        block(f"superresolution.block{k}", i, o, s.sr_in * 2 ** (k + 1), 3)
        i = o
    return sd


# ---------------------------------------------------------------------------
# StyleGAN2
# ---------------------------------------------------------------------------

def _fc(sd, name, x, prec, lr=1.0, act=False):
    w = sd[f"{name}.weight"]
    y = matmul(x, (w * (lr / math.sqrt(w.shape[1]))).T, prec) \
        + sd[f"{name}.bias"] * lr
    return F.leaky_relu(y, 0.2) * math.sqrt(2.0) if act else y


def _norm2(x):
    return x * (x.square().mean(dim=1, keepdim=True) + 1e-8).rsqrt()


def mapping(sd, z, c, prec: str = "float32"):
    m = "backbone.mapping"
    x = torch.cat([_norm2(z), _norm2(_fc(sd, f"{m}.embed", c, prec))], 1)
    i = 0
    while f"{m}.fc{i}.weight" in sd:
        x = _fc(sd, f"{m}.fc{i}", x, prec, lr=0.01, act=True)
        i += 1
    return x


def _fir(x, pad, gain):
    """upfirdn2d with the [1, 3, 3, 1] filter, no resampling: pad
    (before, after) on both axes, the filter normalised times gain."""
    f = torch.tensor(FILTER, device=x.device)
    f = (f[:, None] * f[None, :]) / f.sum() ** 2 * gain
    c = x.shape[1]
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    return F.conv2d(x, f[None, None].repeat(c, 1, 1, 1), groups=c)


def upsample2d(x):
    """upfirdn2d.upsample2d: zeros between samples, pad (2, 1), gain 4."""
    b, c, h, w = x.shape
    z = x.new_zeros(b, c, h, 2, w, 2)
    z[:, :, :, 0, :, 0] = x
    return _fir(z.reshape(b, c, 2 * h, 2 * w), (2, 1), 4.0)


def modulated_conv(x, weight, styles, demodulate, up, prec, noise=None):
    """The fused modconv: per-sample weights as a grouped convolution."""
    b, cin = styles.shape
    cout, _, kh, kw = weight.shape
    w = weight[None] * styles[:, None, :, None, None]
    if demodulate:
        d = (w.square().sum(dim=[2, 3, 4]) + 1e-8).rsqrt()
        w = w * d[:, :, None, None, None]
    xg = round_to(x.reshape(1, b * cin, *x.shape[2:]), prec)
    if up:
        wt = w.transpose(1, 2).reshape(b * cin, cout, kh, kw)
        y = F.conv_transpose2d(xg, round_to(wt, prec), stride=2, groups=b)
        y = _fir(y, (1, 1), 4.0)
    else:
        y = F.conv2d(xg, round_to(w.reshape(b * cout, cin, kh, kw), prec),
                     padding=kh // 2, groups=b)
    y = y.reshape(b, cout, *y.shape[2:])
    return y if noise is None else y + noise


def _layer(sd, name, x, w, prec, up=False, noise=True):
    styles = _fc(sd, f"{name}.affine", w, prec)
    nz = (sd[f"{name}.noise_const"] * sd[f"{name}.noise_strength"]
          if noise else None)
    y = modulated_conv(x, sd[f"{name}.weight"], styles, True, up, prec, nz)
    y = y + sd[f"{name}.bias"][None, :, None, None]
    return F.leaky_relu(y, 0.2) * math.sqrt(2.0)


def _torgb(sd, name, x, w, prec):
    weight = sd[f"{name}.weight"]
    styles = _fc(sd, f"{name}.affine", w, prec) / math.sqrt(
        weight[0].numel())
    y = modulated_conv(x, weight, styles, False, False, prec)
    return y + sd[f"{name}.bias"][None, :, None, None]


def block(sd, name, x, img, w, prec, noise=True):
    if f"{name}.const" in sd:
        x = sd[f"{name}.const"][None].repeat(w.shape[0], 1, 1, 1)
    else:
        x = _layer(sd, f"{name}.conv0", x, w, prec, up=True, noise=noise)
    x = _layer(sd, f"{name}.conv1", x, w, prec, noise=noise)
    y = _torgb(sd, f"{name}.torgb", x, w, prec)
    return x, (y if img is None else upsample2d(img) + y)


def synthesis(sd, s: Sizes, w, prec: str = "float32"):
    """-> the planes (B, 3, plane_ch, plane_res, plane_res)."""
    x = img = None
    for r in channels(s):
        x, img = block(sd, f"backbone.synthesis.b{r}", x, img, w, prec)
    return img.reshape(w.shape[0], 3, s.plane_ch, *img.shape[-2:])


def superresolution(sd, s: Sizes, rgb, feats, w, prec: str = "float32"):
    x, img = feats, rgb
    for k in range(len(s.sr_channels)):
        x, img = block(sd, f"superresolution.block{k}", x, img, w, prec,
                       noise=False)
    return img


# ---------------------------------------------------------------------------
# Camera and rays
# ---------------------------------------------------------------------------

def _unit(v):
    return v / torch.norm(v, dim=-1, keepdim=True)


def cam2world(yaw, pitch, radius=2.7, pivot=(0.0, 0.0, 0.2)):
    """LookAtPoseSampler.sample at the angles (B, 1), no spread."""
    v = torch.clamp(pitch, 1e-5, math.pi - 1e-5) / math.pi
    phi = torch.arccos(1 - 2 * v)
    o = torch.zeros((yaw.shape[0], 3), device=yaw.device)
    o[:, 0:1] = radius * torch.sin(phi) * torch.cos(math.pi - yaw)
    o[:, 2:3] = radius * torch.sin(phi) * torch.sin(math.pi - yaw)
    o[:, 1:2] = radius * torch.cos(phi)
    fwd = _unit(torch.tensor(pivot, device=yaw.device) - o)
    up = torch.tensor([0.0, 1.0, 0.0], device=o.device).expand_as(fwd)
    right = -_unit(torch.cross(up, fwd, dim=-1))
    up = _unit(torch.cross(fwd, right, dim=-1))
    rot = torch.eye(4, device=o.device)[None].repeat(o.shape[0], 1, 1)
    rot[:, :3, :3] = torch.stack((right, up, fwd), dim=-1)
    tr = torch.eye(4, device=o.device)[None].repeat(o.shape[0], 1, 1)
    tr[:, :3, 3] = o
    return tr @ rot


def label(c2w, focal=4.2647):
    """c: cam2world's 16 values, then the normalised intrinsics' 9."""
    b = c2w.shape[0]
    k = torch.tensor([focal, 0, 0.5, 0, focal, 0.5, 0, 0, 1.0],
                     device=c2w.device)
    return torch.cat([c2w.reshape(b, 16), k[None].repeat(b, 1)], 1)


def rays(c, n):
    """RaySampler -> origins, directions (B, n^2, 3)."""
    b = c.shape[0]
    c2w, k = c[:, :16].view(b, 4, 4), c[:, 16:25].view(b, 3, 3)
    fx, fy = k[:, 0, 0], k[:, 1, 1]
    cx, cy, sk = k[:, 0, 2], k[:, 1, 2], k[:, 0, 1]
    ar = torch.arange(n, dtype=torch.float32, device=c.device)
    uv = torch.stack(torch.meshgrid(ar, ar, indexing="ij")) * (1.0 / n) \
        + (0.5 / n)
    uv = uv.flip(0).reshape(2, -1).transpose(1, 0)[None].repeat(b, 1, 1)
    x_cam, y_cam = uv[:, :, 0], uv[:, :, 1]
    z_cam = torch.ones_like(x_cam)
    x_lift = (x_cam - cx[:, None] + cy[:, None] * sk[:, None] / fy[:, None]
              - sk[:, None] * y_cam / fy[:, None]) / fx[:, None] * z_cam
    y_lift = (y_cam - cy[:, None]) / fy[:, None] * z_cam
    pts = torch.stack((x_lift, y_lift, z_cam, torch.ones_like(z_cam)), -1)
    world = torch.bmm(c2w, pts.permute(0, 2, 1)).permute(0, 2, 1)[:, :, :3]
    loc = c2w[:, :3, 3]
    dirs = F.normalize(world - loc[:, None, :], dim=2)
    return loc[:, None, :].repeat(1, dirs.shape[1], 1), dirs


# ---------------------------------------------------------------------------
# ImportanceRenderer
# ---------------------------------------------------------------------------

def sample_planes(planes, coords, box_warp, prec: Products):
    b, n, ch, h, w = planes.shape
    m = coords.shape[1]
    axes = torch.tensor(PLANE_AXES, dtype=torch.float32,
                        device=coords.device).reshape(3, 3, 3)
    inv = torch.linalg.inv(axes)
    x = (2 / box_warp) * coords
    x = x[:, None].expand(-1, n, -1, -1).reshape(b * n, m, 3)
    proj = torch.bmm(round_to(x, prec.field),
                     round_to(inv[None].expand(b, -1, -1, -1)
                              .reshape(b * n, 3, 3), prec.field))[..., :2]
    out = F.grid_sample(round_to(planes.reshape(b * n, ch, h, w), prec.table),
                        proj[:, None], mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.permute(0, 3, 2, 1).reshape(b, n, m, ch)


def decoder(sd, feats, prec: Products):
    """OSGDecoder -> rgb (B, M, C) and sigma (B, M, 1)."""
    x = feats.mean(1)
    b, m, c = x.shape
    x = _fc(sd, "decoder.net.0", x.reshape(b * m, c), prec.heads)
    x = _fc(sd, "decoder.net.2", F.softplus(x), prec.heads).view(b, m, -1)
    return torch.sigmoid(x[..., 1:]) * (1 + 2 * 0.001) - 0.001, x[..., :1]


def march(colors, densities, depths):
    """MipRayMarcher2 on (B, R, S, C), (B, R, S, 1), (B, R, S, 1)."""
    deltas = depths[:, :, 1:] - depths[:, :, :-1]
    colors_mid = (colors[:, :, :-1] + colors[:, :, 1:]) / 2
    densities_mid = (densities[:, :, :-1] + densities[:, :, 1:]) / 2
    depths_mid = (depths[:, :, :-1] + depths[:, :, 1:]) / 2
    densities_mid = F.softplus(densities_mid - 1)
    alpha = 1 - torch.exp(-densities_mid * deltas)
    shifted = torch.cat([torch.ones_like(alpha[:, :, :1]),
                         1 - alpha + 1e-10], -2)
    weights = alpha * torch.cumprod(shifted, -2)[:, :, :-1]
    rgb = torch.sum(weights * colors_mid, -2)
    total = weights.sum(2)
    depth = torch.sum(weights * depths_mid, -2) / total
    depth = torch.nan_to_num(depth, float("inf"))
    depth = torch.clamp(depth, torch.min(depths), torch.max(depths))
    return rgb * 2 - 1, depth, weights


def sample_pdf(bins, weights, u, eps=1e-5):
    n_rays, n = weights.shape
    weights = weights + eps
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    k = u.shape[1]
    inds = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, n)
    idx = torch.stack([below, above], -1).view(n_rays, 2 * k)
    cdf_g = torch.gather(cdf, 1, idx).view(n_rays, k, 2)
    bins_g = torch.gather(bins, 1, idx).view(n_rays, k, 2)
    denom = cdf_g[..., 1] - cdf_g[..., 0]
    denom[denom < eps] = 1
    return bins_g[..., 0] + (u - cdf_g[..., 0]) / denom * (
        bins_g[..., 1] - bins_g[..., 0])


def sample_importance(z_vals, weights, u):
    b, r, s, _ = z_vals.shape
    z_vals = z_vals.reshape(b * r, s)
    weights = weights.reshape(b * r, -1)
    weights = F.max_pool1d(weights.unsqueeze(1), 2, 1, padding=1)
    weights = F.avg_pool1d(weights, 2, 1).squeeze(1) + 0.01
    mids = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    return sample_pdf(mids, weights[:, 1:-1], u.reshape(b * r, -1)).reshape(
        b, r, -1, 1)


def shade(sd, s: Sizes, planes, origins, dirs, jitter, u, rs: RenderSpec,
          prec: Products):
    """One block of rays -> feature samples (B, R, C) in [-1, 1], depth."""
    b, r, n = jitter.shape
    z = torch.linspace(rs.ray_start, rs.ray_end, n, device=jitter.device)
    z = z.reshape(1, 1, n, 1) + jitter[..., None] * (
        (rs.ray_end - rs.ray_start) / (n - 1))

    def run(depths):
        k = depths.shape[2]
        pts = (origins[:, :, None] + depths * dirs[:, :, None]).reshape(
            b, -1, 3)
        rgb, sigma = decoder(sd, sample_planes(planes, pts, s.box_warp, prec),
                             prec)
        return rgb.reshape(b, r, k, -1), sigma.reshape(b, r, k, 1)

    c0, d0 = run(z)
    _, _, w = march(c0, d0, z)
    fine = sample_importance(z, w, u)
    c1, d1 = run(fine)
    depths = torch.cat([z, fine], -2)
    colors = torch.cat([c0, c1], -2)
    dens = torch.cat([d0, d1], -2)
    _, order = torch.sort(depths, dim=-2)
    depths = torch.gather(depths, -2, order)
    colors = torch.gather(colors, -2, order.expand(-1, -1, -1,
                                                   colors.shape[-1]))
    dens = torch.gather(dens, -2, order)
    feats, depth, _ = march(colors, dens, depths)
    return feats, depth


def generate(sd, s: Sizes, rs: RenderSpec, z, c, jitter, u,
             prec: Products = EXACT) -> dict:
    """TriPlaneGenerator at psi 1, noise mode 'const', c also the render
    camera: image (B, 3, 4 n, 4 n), image_raw (B, 3, n, n), depth (B, n, n)."""
    with torch.no_grad():
        w = mapping(sd, z, c, prec.mapping)
        planes = synthesis(sd, s, w, prec.mapping)
        origins, dirs = rays(c, rs.img_size)
        parts = []
        for i in range(0, origins.shape[1], rs.ray_chunk):
            sl = slice(i, i + rs.ray_chunk)
            parts.append(shade(sd, s, planes, origins[:, sl], dirs[:, sl],
                               jitter[:, sl], u[:, sl], rs, prec))
        feats = torch.cat([p[0] for p in parts], 1)
        depth = torch.cat([p[1] for p in parts], 1)
        b, n = z.shape[0], rs.img_size
        fimg = feats.permute(0, 2, 1).reshape(b, -1, n, n)
        image = superresolution(sd, s, fimg[:, :3], fimg, w, prec.mapping)
    return {"image": image, "image_raw": fimg[:, :3],
            "depth": depth.reshape(b, n, n)}
