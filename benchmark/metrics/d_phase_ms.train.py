"""Device time per traced training step of the critics' phases: the
program's spans fenerf/train/d_img and fenerf/train/d_seg (train/loop.py::
train_step: each phase's fakes, its loss with R1, gradients and Adam), from
each span's entry event to its exit event on the stream, idle included."""
from benchmark.harness import spans

UNIT = "ms"


def read(run):
    if run.facts.get("kind") != "train":
        return None
    ms = spans.summed(run, ("fenerf/train/d_img", "fenerf/train/d_seg"))
    return None if ms is None else ms / run.facts["steps"]
