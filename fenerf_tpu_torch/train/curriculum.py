"""Training curricula with step-indexed stage overrides (port of
fenerf_tpu/train/curriculum.py: StageMeta, TrainConfig and every entry of
CURRICULA, field for field).

Int keys mark stage starts; `TrainConfig.at_step(step)` overlays the latest
stage <= step onto the global keys and returns a merged `StageMeta`.
Shape-affecting fields (img_size, num_steps, batch_size, batch_split) are
fixed per stage.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from fenerf_tpu_torch.models.generator import RenderConfig
from fenerf_tpu_torch.nn.discriminators import DiscriminatorConfig
from fenerf_tpu_torch.nn.fields import FieldConfig, get_config
from fenerf_tpu_torch.nn.latent_grid_field import (GridFieldConfig,
                                                   get_grid_config,
                                                   is_grid_model)


@dataclasses.dataclass(frozen=True)
class StageMeta:
    """Fully-resolved per-step training metadata."""
    # stage-varying
    batch_size: int
    num_steps: int
    img_size: int
    batch_split: int
    gen_lr: float
    disc_img_lr: float
    disc_seg_lr: float
    # globals
    fov: float
    ray_start: float
    ray_end: float
    fade_steps: int
    h_stddev: float
    v_stddev: float
    h_mean: float
    v_mean: float
    sample_dist: str
    topk_interval: int
    topk_v: float
    betas: tuple[float, float]
    unique_lr: bool
    weight_decay: float
    r1_lambda: float
    latent_geo_dim: int
    latent_app_dim: int
    output_dim: int
    grad_clip: float
    model: str
    generator: str
    dataset: str
    clamp_mode: str
    z_dist: str
    hierarchical_sample: bool
    z_geo_lambda: float
    z_app_lambda: float
    pos_lambda: float
    last_back: bool
    eval_last_back: bool
    d_seg_loss_lambda: float
    g_seg_loss_lambda: float
    softmax_label: bool
    target_size: int
    fill_mode: str | None
    dataset_path: str
    background_mask: bool
    channel_seg: int = 18
    mapping_lr_mult: float = 5e-2
    # torch route: recompute the field in the G backward (the kernel route
    # saves only its inputs anyway)
    remat: bool = False
    # gradient-subset-of-rays fraction for the G phase (< 1.0 enables;
    # models/generator.py::_shade_grad_subset)
    grad_rays: float = 1.0
    # DiffAugment policy of the image critic's inputs ('' = off;
    # train/diff_augment.py)
    diff_augment_policy: str = ""
    # run the G phase (and the D-phase fakes) over the full batch at once
    # while computing the exact split-structured objective (per-chunk topk +
    # summed per-chunk means): batch_split stays a pure memory knob, only
    # the partition of the random draws differs
    full_batch: bool = False
    # extra FieldConfig replacements, e.g. (("hidden_dim", 16),) for tiny
    # test/dry-run instantiations of the full architecture
    field_overrides: tuple = ()

    # ---- derived configs --------------------------------------------------
    @property
    def family(self) -> str:
        return "grid" if is_grid_model(self.model) else "film"

    def field_config(self) -> FieldConfig | GridFieldConfig:
        """FieldConfig (film family) or GridFieldConfig (latent-grid
        family, one latent of latent_geo_dim)."""
        if self.family == "grid":
            cfg = get_grid_config(self.model, z_dim=self.latent_geo_dim)
        else:
            cfg = get_config(
                self.model,
                z_geo_dim=self.latent_geo_dim,
                z_app_dim=self.latent_app_dim,
                n_labels=self.output_dim - 4,
            )
        if self.field_overrides:
            cfg = dataclasses.replace(cfg, **dict(self.field_overrides))
        return cfg

    def render_config(self, **overrides) -> RenderConfig:
        kw = dict(
            img_size=self.img_size,
            num_steps=self.num_steps,
            fov=self.fov,
            ray_start=self.ray_start,
            ray_end=self.ray_end,
            h_stddev=self.h_stddev,
            v_stddev=self.v_stddev,
            h_mean=self.h_mean,
            v_mean=self.v_mean,
            sample_dist=self.sample_dist,
            hierarchical=self.hierarchical_sample,
            clamp_mode=self.clamp_mode,
            last_back=self.last_back,
            softmax_label=self.softmax_label,
            remat=self.remat,
        )
        kw.update(overrides)
        return RenderConfig(**kw)

    def eval_render_config(self, **overrides) -> RenderConfig:
        kw = dict(fill_mode=self.fill_mode, last_back=self.eval_last_back)
        kw.update(overrides)
        return self.render_config(**kw)

    def disc_img_config(self) -> DiscriminatorConfig:
        return DiscriminatorConfig(
            input_dim=3,
            latent_geo_dim=self.latent_geo_dim,
            latent_app_dim=self.latent_app_dim,
        )

    def disc_seg_config(self) -> DiscriminatorConfig:
        return DiscriminatorConfig(
            input_dim=self.channel_seg + 3,
            latent_geo_dim=self.latent_geo_dim,
            latent_app_dim=self.latent_app_dim,
        )

    def nerf_noise(self, step: int) -> float:
        """Annealed sigma noise (train_double_latent_semantic.py:276)."""
        return max(0.0, 1.0 - step / 5000.0)

    def topk_fraction(self, step: int) -> float:
        """topk-GAN keep fraction (train_double_latent_semantic.py:420)."""
        return max(0.99 ** (step / self.topk_interval), self.topk_v)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    name: str
    stages: tuple[tuple[int, dict[str, Any]], ...]  # (start_step, overrides)
    end_step: int
    defaults: dict[str, Any]

    def stage_start(self, step: int) -> int:
        """Start step of the active stage (== reference last_upsample_step
        for these curricula, used for the fade-in clock)."""
        active = 0
        for s, _ in self.stages:
            if s <= step:
                active = s
        return active

    def next_stage_start(self, step: int) -> int:
        for s, _ in self.stages:
            if s > step:
                return s
        return self.end_step

    def at_step(self, step: int) -> StageMeta:
        merged = dict(self.defaults)
        for s, ov in self.stages:
            if s <= step:
                stage = ov
        merged.update(stage)
        return StageMeta(**merged)

    def alpha(self, step: int) -> float:
        meta = self.at_step(step)
        return min(1.0, (step - self.stage_start(step)) / meta.fade_steps)


_DOUBLE_DEFAULTS = dict(
    dataset_path="data/celebahq_mask",
    background_mask=True,
    fov=12.0, ray_start=0.88, ray_end=1.12, fade_steps=10000,
    h_stddev=0.3, v_stddev=0.155,
    h_mean=math.pi * 0.5, v_mean=math.pi * 0.5,
    sample_dist="gaussian",
    topk_interval=2000, topk_v=0.6,
    betas=(0.0, 0.9), unique_lr=True, weight_decay=0.0, r1_lambda=0.2,
    latent_geo_dim=256, latent_app_dim=256, output_dim=22, grad_clip=10.0,
    generator="DoubleImplicitGenerator3d",
    dataset="CelebAMaskHQ_wo_background_seg_18",
    clamp_mode="relu", z_dist="gaussian", hierarchical_sample=True,
    z_geo_lambda=0.0, z_app_lambda=0.0, pos_lambda=15.0,
    last_back=False, eval_last_back=False,
    d_seg_loss_lambda=0.1, g_seg_loss_lambda=0.1,
    softmax_label=False, target_size=128,
    fill_mode="seg_padding_background",
)

CURRICULA: dict[str, TrainConfig] = {
    "CelebA_double_semantic": TrainConfig(
        name="CelebA_double_semantic",
        stages=(
            (0, dict(batch_size=24, num_steps=12, img_size=32, batch_split=6,
                     gen_lr=5e-5, disc_img_lr=2e-4, disc_seg_lr=1e-4)),
            (10_000, dict(batch_size=12, num_steps=12, img_size=64,
                          batch_split=2, gen_lr=2e-5, disc_img_lr=1e-4,
                          disc_seg_lr=5e-5, remat=True)),
            (50_000, dict(batch_size=4, num_steps=24, img_size=128,
                          batch_split=4, gen_lr=5e-6, disc_img_lr=5e-5,
                          disc_seg_lr=2e-5, remat=True)),
        ),
        end_step=500_000,
        defaults=dict(_DOUBLE_DEFAULTS,
                      model="SIRENBASELINESEMANTICDISENTANGLE"),
    ),
    "CelebA_double_semantic_texture_embedding_256_dim_96": TrainConfig(
        name="CelebA_double_semantic_texture_embedding_256_dim_96",
        stages=(
            (0, dict(batch_size=24, num_steps=24, img_size=32, batch_split=4,
                     gen_lr=6e-5, disc_img_lr=2e-4, disc_seg_lr=2e-4)),
            (20_000, dict(batch_size=48, num_steps=24, img_size=64,
                          batch_split=4, gen_lr=6e-5, disc_img_lr=2e-4,
                          disc_seg_lr=2e-4, remat=True)),
            (50_000, dict(batch_size=24, num_steps=24, img_size=128,
                          batch_split=4, gen_lr=2e-5, disc_img_lr=5e-5,
                          disc_seg_lr=2e-5, remat=True)),
        ),
        end_step=500_000,
        defaults=dict(
            _DOUBLE_DEFAULTS,
            model="TextureEmbeddingPiGAN256SEMANTICDISENTANGLE_DIM_96",
        ),
    ),
    # single-latent pi-GAN baseline (RGB-only; curriculums.py:42-80)
    "CelebA": TrainConfig(
        name="CelebA",
        stages=(
            (0, dict(batch_size=48, num_steps=12, img_size=64, batch_split=2,
                     gen_lr=6e-5, disc_img_lr=2e-4, disc_seg_lr=2e-4)),
        ),
        end_step=200_000,
        defaults=dict(
            dataset_path="data/celebahq/*.jpg",
            background_mask=False,
            fov=12.0, ray_start=0.88, ray_end=1.12, fade_steps=10000,
            h_stddev=0.3, v_stddev=0.155,
            h_mean=math.pi * 0.5, v_mean=math.pi * 0.5,
            sample_dist="gaussian",
            topk_interval=2000, topk_v=0.6,
            betas=(0.0, 0.9), unique_lr=False, weight_decay=0.0,
            r1_lambda=0.2,
            latent_geo_dim=512, latent_app_dim=512, output_dim=4,
            grad_clip=10.0,
            model="SPATIALSIRENBASELINE",
            generator="ImplicitGenerator3d",
            dataset="CelebA",
            clamp_mode="relu", z_dist="gaussian", hierarchical_sample=True,
            z_geo_lambda=0.0, z_app_lambda=0.0, pos_lambda=15.0,
            last_back=False, eval_last_back=True,
            d_seg_loss_lambda=0.0, g_seg_loss_lambda=0.0,
            softmax_label=False, target_size=128,
            fill_mode="eval_white_back",
        ),
    ),
}


# Latent-grid family (SPATIALSIRENGRID + StyleGenerator2D): the reference's
# second released checkpoint ("FENeRF w/ latent grid", README.md:74). The
# reference ships no curriculum for it (checkpoint-only); stage values follow
# the CelebA single-latent recipe (curriculums.py:42-80) with the grid field's
# own dims (siren.py:413-451: z drives StyleGenerator2D(out_res=32, out_ch=32),
# RGB-only output, single-encoder discriminator).
CURRICULA["CelebA_latent_grid"] = TrainConfig(
    name="CelebA_latent_grid",
    stages=(
        # batch_split 16: the grid family's per-point film tensor is large
        (0, dict(batch_size=48, num_steps=12, img_size=64, batch_split=16,
                 gen_lr=6e-5, disc_img_lr=2e-4, disc_seg_lr=2e-4)),
    ),
    end_step=200_000,
    defaults=dict(
        dataset_path="data/celebahq/*.jpg",
        background_mask=False,
        fov=12.0, ray_start=0.88, ray_end=1.12, fade_steps=10000,
        h_stddev=0.3, v_stddev=0.155,
        h_mean=math.pi * 0.5, v_mean=math.pi * 0.5,
        sample_dist="gaussian",
        topk_interval=2000, topk_v=0.6,
        betas=(0.0, 0.9), unique_lr=False, weight_decay=0.0,
        r1_lambda=0.2,
        latent_geo_dim=256, latent_app_dim=0, output_dim=4,
        grad_clip=10.0,
        model="SPATIALSIRENGRID",
        generator="ImplicitGenerator3d",
        dataset="CelebA",
        clamp_mode="relu", z_dist="gaussian", hierarchical_sample=True,
        z_geo_lambda=0.0, z_app_lambda=0.0, pos_lambda=15.0,
        last_back=False, eval_last_back=True,
        d_seg_loss_lambda=0.0, g_seg_loss_lambda=0.0,
        softmax_label=False, target_size=128,
        fill_mode="eval_white_back",
    ),
)


CURRICULA["smoke"] = TrainConfig(
    # CI-sized curriculum exercising a real stage boundary (img/batch change
    # -> recompile + dataloader rebuild + fade-in reset) in seconds
    name="smoke",
    stages=(
        (0, dict(batch_size=8, num_steps=2, img_size=8, batch_split=1,
                 gen_lr=5e-5, disc_img_lr=2e-4, disc_seg_lr=1e-4)),
        (2, dict(batch_size=8, num_steps=3, img_size=16, batch_split=2,
                 gen_lr=2e-5, disc_img_lr=1e-4, disc_seg_lr=5e-5)),
    ),
    end_step=10,
    defaults=dict(_DOUBLE_DEFAULTS, model="SIRENBASELINESEMANTICDISENTANGLE",
                  fade_steps=2),
)


CURRICULA["smoke_grid"] = TrainConfig(
    # CI-sized latent-grid curriculum (tiny field via field_overrides)
    name="smoke_grid",
    stages=(
        (0, dict(batch_size=8, num_steps=2, img_size=8, batch_split=1,
                 gen_lr=6e-5, disc_img_lr=2e-4, disc_seg_lr=2e-4)),
    ),
    end_step=10,
    defaults=dict(
        CURRICULA["CelebA_latent_grid"].defaults,
        fade_steps=2, latent_geo_dim=16,
        field_overrides=(("hidden_dim", 32), ("grid_res", 8), ("grid_ch", 8),
                         ("ch_max", 16), ("map_hidden_dim", 32)),
    ),
)


def get_curriculum(name: str) -> TrainConfig:
    return CURRICULA[name]
