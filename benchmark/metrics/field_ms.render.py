"""Device time per image of the field's evaluations in a render cell: the
program's span fenerf/render/field (models/generator.py::_shade_rays, the
coarse and the fine evaluation of each ray block, either family), entry
event to exit event, idle included."""
from benchmark.harness import spans

UNIT = "ms"


def read(run):
    if run.facts.get("kind") != "render":
        return None
    ms = spans.summed(run, ("fenerf/render/field",))
    return None if ms is None else ms / run.facts["images"]
