"""Device time per image of the render's own work, its field evaluations
left out: the self time of the program's span fenerf/render (models/
generator.py::render_core: cameras and rays, the proposal and resample,
merge and compositing, fill), idle included."""
from benchmark.harness import spans

UNIT = "ms"


def read(run):
    if run.facts.get("kind") != "render":
        return None
    ms = spans.summed(run, ("fenerf/render",), key="self_device_ms")
    return None if ms is None else ms / run.facts["images"]
