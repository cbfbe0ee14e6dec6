"""Finds the benchmark's pieces by name, each in a file of its own:

  workloads/<cell>.json     a cell: its configuration, traffic, chips, why
  configs/<config>.json     a configuration's sizes (+ its flops file)
  traffic/<traffic>.json    a traffic mix's parameters, naming its driver
  drivers/<driver>.py       the one generator of a traffic kind
  metrics/<metric>.py       one reader per per-layer metric

Adding a cell, a configuration, a traffic mix or a metric adds files; no
file that is there needs an edit.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A Python file as a module, by path (names may hold '-' and '.')."""
    path = Path(path)
    if not path.is_absolute():
        path = REPO / path
    try:
        where = str(path.relative_to(REPO))
    except ValueError:
        where = str(path)
    name = "bench_" + "".join(ch if ch.isalnum() else "_" for ch in where)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _named(folder: str, name: str, suffix: str, root: Path) -> Path:
    path = root / folder / f"{name}{suffix}"
    if not path.is_file():
        have = sorted(p.name[:-len(suffix)]
                      for p in (root / folder).glob(f"*{suffix}"))
        raise KeyError(f"no {folder[:-1]} {name!r} in {root / folder} "
                       f"(have {have})")
    return path


def workload(name: str, root: Path = ROOT) -> dict:
    cell = load_json(_named("workloads", name, ".json", root))
    cell.setdefault("name", name)
    return cell


def config(name: str, root: Path = ROOT) -> dict:
    return load_json(_named("configs", name, ".json", root))


def traffic(name: str, root: Path = ROOT) -> dict:
    return load_json(_named("traffic", name, ".json", root))


def driver(name: str, root: Path = ROOT):
    return load_module(_named("drivers", name, ".py", root))


def flops(cfg: dict):
    return load_module(REPO / cfg["flops"])


def metric_readers(root: Path = ROOT) -> dict:
    """{metric name: module with read(run) -> float | None}."""
    return {p.name[:-3]: load_module(p)
            for p in sorted((root / "metrics").glob("*.py"))
            if not p.name.startswith("_")}


def device_peaks(root: Path = ROOT) -> dict:
    return load_json(root / "device.json")
