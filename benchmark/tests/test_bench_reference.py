"""The plain reference against fenerf_tpu_torch's torch routes on the CPU
(float32 both sides), and the benchmark's weights in the program's trees."""

import pytest
import torch

from benchmark.harness import weights
from benchmark.reference import critics, film_field, grid_field
from benchmark.reference import render as ref_render
from benchmark.tests import tiny

from fenerf_tpu_torch.models import generator as gen  # noqa: E402
from fenerf_tpu_torch.nn import discriminators as disc  # noqa: E402
from fenerf_tpu_torch.nn import fields, latent_grid_field as lgf  # noqa: E402

FILM_FULL = tiny.registry_config("film-dim96")
GRID_FULL = tiny.registry_config("grid-siren")


def _spec_shapes(tree, path=()):
    if isinstance(tree, weights.Spec):
        return {path: tree.shape}
    out = {}
    items = sorted(tree.items()) if isinstance(tree, dict) else \
        enumerate(tree)
    for k, v in items:
        out.update(_spec_shapes(v, path + (k,)))
    return out


def _program_shapes(tree, path=()):
    if isinstance(tree, torch.Tensor):
        return {path: tuple(tree.shape)}
    out = {}
    items = sorted(tree.items()) if isinstance(tree, dict) else \
        enumerate(tree)
    for k, v in items:
        out.update(_program_shapes(v, path + (k,)))
    return out


@pytest.mark.parametrize("family", ["film", "grid", "critics"])
def test_weights_have_the_program_trees_at_full_width(family):
    g = torch.Generator()
    if family == "film":
        c = FILM_FULL
        cfg = fields.get_config(c["model"], n_labels=c["n_labels"])
        mine = _spec_shapes(weights.film_field(c))
        theirs = _program_shapes(fields.init_field(g, cfg, device="meta"))
    elif family == "grid":
        c = GRID_FULL
        mine = _spec_shapes(weights.grid_field(c))
        theirs = _program_shapes(lgf.init_grid_field(
            g, lgf.get_grid_config(c["model"]), device="meta"))
    else:
        head = 1 + 256 + 256 + 2
        mine = _spec_shapes(weights.critic(21, head))
        theirs = _program_shapes(disc.init_discriminator(
            g, disc.DiscriminatorConfig(input_dim=21), device="meta"))
    assert {p: tuple(s) for p, s in mine.items()} == theirs


def _film_cfg():
    c = {**FILM_FULL, **tiny.FILM}
    return c, fields.get_config(
        c["model"], n_labels=c["n_labels"], hidden_dim=c["hidden_dim"],
        map_hidden_dim=c["map_hidden_dim"],
        grid_resolution=c["grid_resolution"],
        grid_channels=c["grid_channels"], z_geo_dim=c["z_geo_dim"],
        z_app_dim=c["z_app_dim"])


def test_film_field_matches_the_torch_route():
    c, cfg = _film_cfg()
    w = weights.materialize(weights.film_field(c), 11, "cpu")
    g = torch.Generator().manual_seed(1)
    zg, za = torch.randn(2, 16, generator=g), torch.randn(2, 16, generator=g)
    pts = (torch.rand(2, 50, 3, generator=g) - 0.5) * 0.3
    drs = torch.nn.functional.normalize(torch.randn(2, 50, 3, generator=g),
                                        dim=-1)
    film = fields.field_film(w, cfg, zg, za)
    mine = film_field.film(w, zg, za)
    for a, b in zip(film, mine):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)
    out = fields.apply_field(w, cfg, pts, drs, *film)
    ref = film_field.field(w, pts, drs, *mine)
    # the program's polynomial sine is within 1.7e-5 of the sine
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-4)


def test_grid_field_and_plane_match_the_torch_route():
    c = {**GRID_FULL, **tiny.GRID}
    cfg = lgf.get_grid_config(c["model"], z_dim=c["z_dim"],
                              hidden_dim=c["hidden_dim"],
                              grid_res=c["grid_res"], grid_ch=c["grid_ch"],
                              ch_max=c["ch_max"],
                              map_hidden_dim=c["map_hidden_dim"])
    w = weights.materialize(weights.grid_field(c), 12, "cpu")
    g = torch.Generator().manual_seed(2)
    z = torch.randn(2, 16, generator=g)
    plane = lgf.compute_plane(w, cfg, z)
    mine = grid_field.plane(w, z)
    torch.testing.assert_close(plane, mine, rtol=1e-4,
                               atol=1e-4 * float(mine.abs().max()))
    pts = (torch.rand(2, 40, 3, generator=g) - 0.5) * 0.3
    drs = torch.nn.functional.normalize(torch.randn(2, 40, 3, generator=g),
                                        dim=-1)
    out = lgf.apply_grid_field(w, cfg, pts, drs, z, plane=plane)
    ref = grid_field.field(w, pts, drs, plane, grid_res=c["grid_res"])
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-4)


@pytest.mark.parametrize("alpha", [0.0, 0.37, 1.0])
def test_critic_matches_the_program(alpha):
    head = 1 + 16 + 16 + 2
    w = weights.materialize(weights.critic(21, head), 13, "cpu")
    cfg = disc.DiscriminatorConfig(input_dim=21, latent_geo_dim=16,
                                   latent_app_dim=16)
    x = torch.rand(3, 21, 16, 16, generator=torch.Generator().manual_seed(3))
    for a, b in zip(disc.apply_discriminator(w, cfg, x * 2 - 1, alpha),
                    critics.critic(w, x * 2 - 1, alpha)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_render_matches_render_core():
    c, cfg = _film_cfg()
    w = weights.materialize(weights.film_field(c), 14, "cpu")
    w["sigma_head"]["b"] += 20.0
    g = torch.Generator().manual_seed(4)
    n, s, b = 8, 6, 2
    zg, za = torch.randn(b, 16, generator=g), torch.randn(b, 16, generator=g)
    d = ref_render.Draws(torch.rand(b, n * n, s, generator=g),
                         torch.rand(b, n * n, s, generator=g),
                         torch.randn(b, 1, generator=g),
                         torch.randn(b, 1, generator=g))
    rcfg = gen.RenderConfig(img_size=n, num_steps=s, sample_dist="gaussian",
                            fill_mode="seg_padding_background")
    out = gen.render_from_z(w, cfg, rcfg, zg, za, draws=gen.RenderDraws(
        d.jitter, d.cam_h, d.cam_v, gen.RayNoise(d.u, None, None)))
    films = film_field.film(w, zg, za)
    spec = ref_render.RenderSpec(img_size=n, num_steps=s,
                                 fill_mode="seg_padding_background")
    ref = ref_render.render(
        lambda p, dr: film_field.field(w, p, dr, *films), spec, d, b)
    for k in ("pixels", "depth", "opacity", "position"):
        torch.testing.assert_close(out[k], ref[k], rtol=0, atol=5e-4)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_tiny_cell_is_correct_against_the_reference(cell):
    res = tiny.execute(tiny.tiny_run(cell))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    e2e = {"film-train-128": "train_img_per_s"}.get(cell, "render_img_per_s")
    assert set(res["metrics"]) == {"setup_s", e2e}
