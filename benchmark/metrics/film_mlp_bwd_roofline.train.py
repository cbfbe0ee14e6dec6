"""film_mlp_bwd's share of its roofline in a training cell: the least time
of the backward's required work (input and weight gradients, twice the
forward's products, at G's rows; no recompute) at the bf16 peak, or its
rows' bytes and each call's weights (bf16 in, f32 gradient out) at the
memory's rate, over the device time of the backward kernels (row, dW and
reduction) in the traced steps."""
from benchmark.harness import readers

UNIT = "%"


def read(run):
    if run.facts.get("kind") != "train" or run.timeline is None:
        return None
    seconds, _ = readers.device_time(
        run.timeline, lambda n: readers.is_kernel(n, readers.FILM_MLP_BWD))
    _, calls = readers.device_time(
        run.timeline, lambda n: readers.is_kernel(n, ("bwd_rows_kernel",)))
    if not calls:
        return None
    c, f = run.config, run.flops
    rows = run.facts["g_rows_per_step"] * run.facts["steps"]
    need = readers.least_seconds(
        2 * rows * f.field_flops_per_point(c),
        rows * f.field_bwd_bytes_per_row(c) + calls * 6 * f.field_weights(c),
        run.peaks)
    return 100.0 * need / seconds
