"""Device time per traced training step of the generator's phase: the
program's span fenerf/train/g (train/loop.py::train_step: G's microbatches
with their renders, critics, backward and f32 accumulation, the table's
fold, G's Adam and both EMA updates), entry event to exit event, idle
included."""
from benchmark.harness import spans

UNIT = "ms"


def read(run):
    if run.facts.get("kind") != "train":
        return None
    ms = spans.summed(run, ("fenerf/train/g",))
    return None if ms is None else ms / run.facts["steps"]
