"""Share of a render cell's traced stretch in which no device operation ran
while the host's innermost program span was fenerf/render itself: in a
render, not in a field evaluation (whole idle gaps on the profiler's
timeline)."""
from benchmark.harness import spans

UNIT = "%"


def read(run):
    if run.facts.get("kind") != "render" or run.timeline is None:
        return None
    return spans.idle_share_under(run.timeline, "fenerf/render")
