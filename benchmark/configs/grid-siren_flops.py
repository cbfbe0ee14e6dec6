"""Operations and bytes of grid-siren (FENeRF's latent-grid SIREN field with
its StyleGAN2 plane), from the configuration's widths.

Counts are the work the algorithm requires: each product 2 * m * k * n.
The per-point mapping's products are float32 and the FiLM layers' bf16
(the configuration's "products"); the plane is counted once per render.
The program never supplies a count.
"""
from __future__ import annotations


def mapping_flops_per_point(c: dict) -> int:
    """grid_ch -> map_hidden -> map_hidden -> 2 * (trunk + colour) * hidden."""
    m, h = c["map_hidden_dim"], c["hidden_dim"]
    n_film = c["trunk_layers"] + c["color_layers"]
    return 2 * (c["grid_ch"] * m + m * m + m * 2 * n_film * h)


def film_flops_per_point(c: dict) -> int:
    """The FiLM layers' products (trunk and colour)."""
    h = c["hidden_dim"]
    return 2 * (3 * h + (c["trunk_layers"] - 1) * h * h
                + (h + 3) * h * c["color_layers"])


def head_flops_per_point(c: dict) -> int:
    h = c["hidden_dim"]
    return 2 * (h + h * c["rgb_dim"])


def plane_flops(c: dict) -> int:
    """The StyleGAN2 plane of one latent: its 3 mapping linears, the
    modulations and the 3x3 modulated convolutions at 4..grid_res (the
    upsampling ones counted at their output size) and the 1x1 projection."""
    z, ch = c["z_dim"], c["ch_max"]
    flops = 3 * 2 * z * z
    res, convs = 4, [(4, ch)]
    while res < c["grid_res"]:
        res *= 2
        convs += [(res, ch), (res, ch)]
    for r, cout in convs:
        flops += 2 * z * ch + 2 * r * r * 9 * ch * cout
    flops += 2 * z * ch + 2 * c["grid_res"] ** 2 * ch * c["grid_ch"]
    return flops


def render_ops(c: dict, images: int, img_size: int, num_steps: int) -> dict:
    """Operations by precision of `images` renders, coarse and fine passes."""
    rows = images * img_size * img_size * 2 * num_steps
    return {"bfloat16": rows * film_flops_per_point(c),
            "float32": rows * (mapping_flops_per_point(c)
                               + head_flops_per_point(c))
            + images * plane_flops(c)}
