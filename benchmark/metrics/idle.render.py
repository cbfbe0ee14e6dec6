"""Share of the traced stretch of a render cell in which no operation ran
on the device: the union of device intervals, overlaps counted once."""
from benchmark.harness import trace

UNIT = "%"


def read(run):
    if run.facts.get("kind") != "render" or run.timeline is None:
        return None
    return trace.idle_share(run.timeline)
