"""film_mlp's share of its roofline in a render cell: the least time of the
forward's required work (products of every row evaluated at the bf16
peak, or its rows' input and output bytes and each call's bf16 weights at
the memory's rate, whichever is larger) over the device time of the
film_mlp kernels in the traced stretch."""
from benchmark.harness import readers

UNIT = "%"


def read(run):
    if run.facts.get("kind") != "render" or run.timeline is None:
        return None
    seconds, calls = readers.device_time(
        run.timeline, lambda n: readers.is_kernel(n, readers.FILM_MLP))
    if not calls:
        return None
    c, f = run.config, run.flops
    rows = (run.facts["images"] * run.facts["rays_per_image"]
            * run.facts["samples"])
    need = readers.least_seconds(
        rows * f.field_flops_per_point(c),
        rows * f.field_bytes_per_row(c) + calls * 2 * f.field_weights(c),
        run.peaks)
    return 100.0 * need / seconds
