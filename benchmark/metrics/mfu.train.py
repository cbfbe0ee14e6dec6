"""The training steps' required operations (the configuration's flops file:
the field's renders and backward, the mapping, the critics' forward,
backward and R1) as a share of the published peaks over the traced steps'
wall time."""
from benchmark.harness import readers

UNIT = "%"


def read(run):
    if run.facts.get("kind") != "train" or run.timeline is None:
        return None
    t = run.traffic
    per_step = run.flops.train_step_ops(run.config, t["batch"],
                                        t["img_size"], t["num_steps"])
    ops = {p: n * run.facts["steps"] for p, n in per_step.items()}
    return readers.peak_share(ops, run.timeline.window_s, run.peaks)
