"""Operations of eg3d-ffhq512 (EG3D's tri-plane generator, ffhq512-128),
from the configuration's widths.

Counts are the work the algorithm requires: each product 2 * m * k * n;
a 3 x 3 convolution at its output size, the upsampling ones (stride-2
transposed convolutions) at their input size; the [1, 3, 3, 1] filters and
the plane sampling are not products. Every product is float32 (the
configuration's "products"). The program never supplies a count.
"""
from __future__ import annotations

import math


def _channels(c: dict) -> dict:
    res = [2 ** i for i in range(2, int(math.log2(c["plane_res"])) + 1)]
    return {r: min(c["channel_base"] // r, c["channel_max"]) for r in res}


def _block_flops(c: dict, cin: int, cout: int, res: int, img_ch: int) -> int:
    """A synthesis block: conv0 (up) or the constant, conv1, ToRGB, and the
    modulations of their input channels."""
    w = c["w_dim"]
    flops = 2 * 9 * cout * cout * res * res + 2 * w * cout
    if cin:
        flops += 2 * 9 * cin * cout * (res // 2) ** 2 + 2 * w * cin
    return flops + 2 * cout * img_ch * res * res + 2 * w * cout


def mapping_flops(c: dict) -> int:
    w = c["w_dim"]
    return 2 * (c["c_dim"] * w + (c["z_dim"] + w) * w
                + (c["map_depth"] - 1) * w * w)


def backbone_flops(c: dict) -> int:
    ch = _channels(c)
    return sum(_block_flops(c, ch.get(r // 2, 0), o, r, 3 * c["plane_ch"])
               for r, o in ch.items())


def superres_flops(c: dict) -> int:
    flops, cin = 0, c["plane_ch"]
    for i, o in enumerate(c["sr_channels"]):
        flops += _block_flops(c, cin, o, c["sr_in"] * 2 ** (i + 1), 3)
        cin = o
    return flops


def decoder_flops_per_point(c: dict) -> int:
    h, f = c["decoder_hidden"], c["plane_ch"]
    return 2 * (f * h + h * (f + 1))


def render_ops(c: dict, images: int, img_size: int, num_steps: int) -> dict:
    """Operations by precision of `images` generations: the mapping, the
    backbone, the decoder over the coarse and fine samples of
    img_size^2 rays, the super-resolution."""
    rows = images * img_size * img_size * 2 * num_steps
    return {"float32": rows * decoder_flops_per_point(c)
            + images * (mapping_flops(c) + backbone_flops(c)
                        + superres_flops(c))}
