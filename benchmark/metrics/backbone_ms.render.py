"""Device time per image of the tri-plane backbone in a render cell: the
program's span fenerf/eg3d/backbone (nn/triplane_field.py::planes, the
StyleGAN2 synthesis of the three planes), entry event to exit event, idle
included."""
from benchmark.harness import spans

UNIT = "ms"


def read(run):
    if run.facts.get("kind") != "render":
        return None
    ms = spans.summed(run, ("fenerf/eg3d/backbone",))
    return None if ms is None else ms / run.facts["images"]
