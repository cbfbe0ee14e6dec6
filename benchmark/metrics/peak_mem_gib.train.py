"""torch.cuda.max_memory_allocated over a training cell's window, GiB."""
UNIT = "GiB"


def read(run):
    if run.facts.get("kind") != "train" or "window_peak_bytes" not in \
            run.facts:
        return None
    return run.facts["window_peak_bytes"] / 2 ** 30
