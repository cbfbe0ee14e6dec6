"""Device time per image of the tri-plane sampling in a render cell: the
program's span fenerf/render/field/planes (nn/triplane_field.py::
sample_planes inside each field evaluation: the projection, the bilinear
samples of the three planes, their mean), entry event to exit event, idle
included."""
from benchmark.harness import spans

UNIT = "ms"


def read(run):
    if run.facts.get("kind") != "render":
        return None
    ms = spans.summed(run, ("fenerf/render/field/planes",))
    return None if ms is None else ms / run.facts["images"]
