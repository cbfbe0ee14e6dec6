"""Points per field evaluation in a render cell: the rows counted by the
program's span fenerf/render/field over its calls (images per render x rays
per ray block x samples)."""
from benchmark.harness import spans

UNIT = "rows"


def read(run):
    if run.facts.get("kind") != "render":
        return None
    t = spans.table(run)
    field = (t or {}).get("fenerf/render/field")
    if not field or "rows" not in field["counts"]:
        return None
    return field["counts"]["rows"] / field["calls"]
