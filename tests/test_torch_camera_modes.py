"""An unknown camera mode renders the deterministic mean pose, as the JAX
package's sample_camera does (its else branch): the port's camera against
the JAX function's, and a whole render at such a mode against the render
at the mean pose."""
import math

import numpy as np
import pytest

import jax
import torch

from fenerf_tpu.core import rays as jrays
from fenerf_tpu_torch.core import rays as trays
from fenerf_tpu_torch.models import generator as tgen
from fenerf_tpu_torch.nn import fields as tfields

torch.set_num_threads(2)

CAM = dict(h_stddev=0.3, v_stddev=0.155, h_mean=math.pi / 2 + 0.2,
           v_mean=math.pi / 2 - 0.1)


@pytest.mark.parametrize("mode", ["spiral", "orbit", ""])
def test_unknown_mode_is_the_mean_pose(mode):
    ref = jrays.sample_camera(jax.random.key(3), 4, mode=mode, **CAM)
    out = trays.sample_camera(4, mode=mode, **CAM)
    for name, a, b in zip(("origin", "pitch", "yaw"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0, err_msg=name)
    mean = trays.sample_camera(4, mode=None, **CAM)
    for a, b in zip(out, mean):
        assert torch.equal(a, b)


def test_render_at_unknown_mode_is_the_mean_pose_render():
    cfg = tfields.get_config(
        "TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96", hidden_dim=16,
        z_geo_dim=8, z_app_dim=8, map_hidden_dim=16, grid_resolution=8,
        grid_channels=4)
    params = tfields.init_field(torch.Generator().manual_seed(0), cfg)
    params["sigma_head"]["b"] = params["sigma_head"]["b"] + 5.0
    g = torch.Generator().manual_seed(1)
    z = torch.randn((2, 8), generator=g)
    film_geo, film_app = tfields.field_film(params, cfg, z, z.flip(0))
    base = dict(img_size=8, num_steps=6, hierarchical=True, perturb=True)
    spiral = tgen.RenderConfig(sample_dist="spiral", **base)
    gaussian = tgen.RenderConfig(sample_dist="gaussian", **base)
    out = {}
    for key, rcfg, camera in (
            ("spiral", spiral, None),
            ("mean", spiral, (spiral.v_mean, spiral.h_mean, spiral.fov)),
            ("gaussian", gaussian, None)):
        with torch.no_grad():
            out[key] = tgen.render(
                params, cfg, rcfg, film_geo, film_app, 2, camera=camera,
                generator=torch.Generator().manual_seed(5))
    for k in ("pixels", "depth", "position"):
        assert torch.equal(out["spiral"][k], out["mean"][k]), k
    # a drawn pose differs (the draws are not silently dropped everywhere)
    assert not torch.equal(out["gaussian"]["position"],
                           out["mean"]["position"])
