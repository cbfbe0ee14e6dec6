"""Tiny sizes of every cell for the CPU tests: the same code paths, the
published widths cut so that a run takes seconds."""
import time

from benchmark.harness import core
from benchmark.reference import precision

FILM = {"hidden_dim": 32, "map_hidden_dim": 32, "grid_resolution": 8,
        "grid_channels": 8, "z_geo_dim": 16, "z_app_dim": 16}
GRID = {"hidden_dim": 32, "map_hidden_dim": 32, "z_dim": 16, "ch_max": 16,
        "grid_res": 8, "grid_ch": 8}
RENDER = {"img_size": 8, "num_steps": 6, "ray_chunk": 16, "batch": 2,
          "check_images": 3, "trace_batches": 2}
VIDEO = {"img_size": 8, "num_steps": 6, "ray_chunk": 16, "num_frames": 3,
         "check_frames": 2, "trace_frames": 2}
TRAIN = {"img_size": 16, "num_steps": 4, "batch": 4, "batch_split": 2,
         "ref_ray_chunk": 64, "follow_steps": 2, "trace_steps": 1}
CELLS = {"film-render-128": (FILM, RENDER), "grid-video-128": (GRID, VIDEO),
         "film-train-128": (FILM, TRAIN)}


# what the program computes on the CPU, where no kernel runs: the film
# family's eval renders and training steps take the torch route in float32;
# the grid family's takes bf16 operands in its FiLM layers, float32 heads
CPU_PRECISION = {
    "film-render-128": precision.EXACT, "film-train-128": precision.EXACT,
    "grid-video-128": precision.Products(field="bfloat16")}


def tiny_run(cell: str, seed: int = 2 ** 31 + 7, seconds: float = 0.2,
             trace: bool = False, root=None) -> core.Run:
    cfg, traffic = CELLS[cell]
    kw = {} if root is None else {"root": root}
    run = core.Run(cell, seed, seconds, trace, device="cpu",
                   overrides={"config": cfg, "traffic": traffic}, **kw)
    run.reference = CPU_PRECISION[cell]
    return run


def execute(run: core.Run) -> dict:
    return core.execute(run, time.monotonic())


def registry_config(name: str) -> dict:
    from benchmark.harness import registry

    return registry.config(name)
