"""Faults planted in the program underneath a run, to show that `correct`
comes out false on them (the CPU tests at a tiny size; calibrate.py on the
card at the cell's size). Each driver's `faults()` names the ones its cell
can have."""
from __future__ import annotations

import contextlib


def planted(obj, name: str, wrap):
    """A context that replaces obj.name by wrap(obj.name) and restores it."""
    @contextlib.contextmanager
    def plant():
        old = getattr(obj, name)
        setattr(obj, name, wrap(old))
        try:
            yield
        finally:
            setattr(obj, name, old)
    return plant


def altered_pixels(fn):
    """A render whose pixels are shifted where they are produced."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        return {**out, "pixels": out["pixels"] + 0.5}
    return wrapped
