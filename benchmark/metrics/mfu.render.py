"""The renders' required operations (the configuration's flops file: field
products at their precision, mapping, plane) as a share of the published
peaks over the traced stretch's wall time."""
from benchmark.harness import readers

UNIT = "%"


def read(run):
    if run.facts.get("kind") != "render" or run.timeline is None:
        return None
    t = run.traffic
    ops = run.flops.render_ops(run.config, run.facts["images"],
                               t["img_size"], t["num_steps"])
    return readers.peak_share(ops, run.timeline.window_s, run.peaks)
