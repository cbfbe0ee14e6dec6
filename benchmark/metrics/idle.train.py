"""Share of the traced training steps in which no operation ran on the
device: the union of device intervals, overlaps counted once."""
from benchmark.harness import trace

UNIT = "%"


def read(run):
    if run.facts.get("kind") != "train" or run.timeline is None:
        return None
    return trace.idle_share(run.timeline)
