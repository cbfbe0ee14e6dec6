"""Builds the port's CUDA sources (ops/csrc/<name>.cu) with nvcc for sm_90a
into build/ (gitignored), once per source content (the .cu and the shared
csrc/*.cuh headers), and loads them with ctypes. Each source has a plain C
interface, so nvcc takes seconds.

`build(names)` starts one nvcc per missing library, all at once, and waits
for them; `library(name)` builds one if needed and returns the loaded
ctypes.CDLL (cached per process).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
# every kernel source of the port (ops/csrc/<name>.cu)
KERNELS = ("film_mlp", "film_mlp_bwd", "ray_finalize", "zexp_fold",
           "mxu_chain", "mxu_wide", "dma_gather")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
BUILD_LOG: dict[str, str] = {}   # name -> nvcc output of this process's build
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _so_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    tag = digest.hexdigest()[:16]
    return BUILD_DIR / f"{name}_{tag}.so"


def command(src: Path, out: Path) -> list[str]:
    """The nvcc command that builds one source (including csrc/*.cuh) into
    a shared library for sm_90a."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-I", str(CSRC), "-o", str(out), str(src)]


def build(names) -> None:
    """Compile every named source whose library is missing, one nvcc
    process each, all started together; raise if any fails."""
    jobs = []
    for name in names:
        so = _so_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(command(CSRC / f"{name}.cu", tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, so, tmp, proc))
    failed = []
    for name, so, tmp, proc in jobs:
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ops/csrc/<name>.cu, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_so_path(name)))
            _LIBS[name] = lib
        return lib
