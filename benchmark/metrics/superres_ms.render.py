"""Device time per image of the super-resolution in a render cell: the
program's span fenerf/eg3d/superres (nn/triplane_field.py::superres, two
StyleGAN2 synthesis blocks from the feature image to the output), entry
event to exit event, idle included."""
from benchmark.harness import spans

UNIT = "ms"


def read(run):
    if run.facts.get("kind") != "render":
        return None
    ms = spans.summed(run, ("fenerf/eg3d/superres",))
    return None if ms is None else ms / run.facts["images"]
