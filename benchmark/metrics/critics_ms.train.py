"""Device time per training step of the critics' convolutions (cuDNN
kernels by name: D_img and D_seg, their backward, R1's double backward and
G's pass through them)."""
from benchmark.harness import readers

UNIT = "ms"


def read(run):
    if run.facts.get("kind") != "train" or run.timeline is None:
        return None
    seconds, calls = readers.device_time(run.timeline, readers.is_conv)
    if not calls:
        return None
    return 1e3 * seconds / run.facts["steps"]
