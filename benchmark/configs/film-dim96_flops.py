"""Operations and bytes of film-dim96 (FENeRF's texture-embedding FiLM-SIREN
field and its CoordConv critics), from the configuration's widths.

Counts are the work the algorithm requires, as the published model states
it: each product 2 * m * k * n, the label head's linear chain folded into
one (hidden, labels) product (it has no activation), no recompute, the
inputs and outputs of a kernel counted once. The program never supplies a
count.
"""
from __future__ import annotations


def field_flops_per_point(c: dict) -> int:
    """Products of one field evaluation (trunk, folded heads, colour)."""
    h, g = c["hidden_dim"], c["grid_channels"]
    k = (3 * h + (c["trunk_layers"] - 1) * h * h          # trunk
         + h * (1 + c["n_labels"])                         # sigma + labels
         + (3 + g + h) * h + (c["color_layers"] - 1) * h * h   # colour
         + h * c["rgb_dim"])                               # rgb head
    return 2 * k


def field_weights(c: dict) -> int:
    """Weights the fused field reads per call (folded heads)."""
    h, g = c["hidden_dim"], c["grid_channels"]
    return (3 * h + (c["trunk_layers"] - 1) * h * h + h * (1 + c["n_labels"])
            + (3 + g + h) * h + (c["color_layers"] - 1) * h * h
            + h * c["rgb_dim"])


def field_bytes_per_row(c: dict) -> int:
    """Forward: point and direction (f32), texture features (bf16) in; the
    output row (f32) out."""
    out = c["n_labels"] + c["rgb_dim"] + 1
    return 4 * 3 + 4 * 3 + 2 * c["grid_channels"] + 4 * out


def field_bwd_bytes_per_row(c: dict) -> int:
    """Backward: the forward's inputs and the output cotangent (f32) in,
    the texture features' cotangent (bf16) out."""
    out = c["n_labels"] + c["rgb_dim"] + 1
    return 4 * 3 + 4 * 3 + 2 * c["grid_channels"] + 4 * out \
        + 2 * c["grid_channels"]


def mapping_flops(c: dict) -> int:
    """Both mapping networks for one latent pair (5 linears each)."""
    h, m = c["hidden_dim"], c["map_hidden_dim"]
    geo = c["z_geo_dim"] * m + 3 * m * m + m * 2 * c["trunk_layers"] * h
    app = c["z_app_dim"] * m + 3 * m * m + m * 2 * c["color_layers"] * h
    return 2 * (geo + app)


def critic_flops(c: dict, input_dim: int, size: int,
                 fade: bool = True) -> int:
    """One forward of the CoordConv critic on one size x size image: the
    1x1 entry adapter, the residual blocks from that size down to 2 x 2
    (3x3 conv + coords, 3x3 stride-2 conv + coords, 1x1 stride-2 skip),
    with `fade` the second adapter on the 2x-downsampled input, and the
    final 2x2 conv."""
    ch = c["critic_channels"]
    n_blocks = len(ch) - 1
    start = 8 - size.bit_length() + 1
    flops = 2 * size * size * input_dim * ch[start]
    if fade:
        flops += 2 * (size // 2) ** 2 * input_dim * ch[start + 1]
    r = size
    for i in range(start, n_blocks):
        cin, cout = ch[i], ch[i + 1]
        flops += 2 * r * r * 9 * (cin + 2) * cout
        flops += 2 * (r // 2) ** 2 * 9 * (cout + 2) * cout
        flops += 2 * (r // 2) ** 2 * cin * cout
        r //= 2
    flops += 2 * 4 * ch[-1] * c["critic_head_dim"]
    return flops


def render_ops(c: dict, images: int, img_size: int, num_steps: int) -> dict:
    """Operations by precision of `images` renders: coarse and fine field
    passes of num_steps samples per ray, the mapping of each latent pair."""
    rows = images * img_size * img_size * 2 * num_steps
    return {"bfloat16": rows * field_flops_per_point(c),
            "float32": images * mapping_flops(c)}


def train_step_ops(c: dict, batch: int, img_size: int,
                   num_steps: int) -> dict:
    """Operations by precision of one training step at `batch`:
      field   the D_img and D_seg fakes (forward), G's render (forward)
              and its backward (input and weight gradients, 2x forward)
      mapping three latent batches forward, G's backward (2x)
      critics per critic, the D phase: fakes forward and backward (3F),
              reals forward, R1's input gradient, the loss's backward
              through the reals (2F) and R1's double backward (2F): 9F;
              the G phase: forward and input gradient (2F)."""
    rows = batch * img_size * img_size * 2 * num_steps
    field = 5 * rows * field_flops_per_point(c)
    mapping = 5 * batch * mapping_flops(c)
    per_image = (critic_flops(c, 3, img_size)
                 + critic_flops(c, c["n_labels"] + 3, img_size))
    return {"bfloat16": field,
            "float32": mapping + batch * per_image * (9 + 2)}
