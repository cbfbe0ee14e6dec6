"""ctypes bindings and build of the port's host image codec
(data/native/codec.cpp): baseline JPEG decode and PNG scanline unfilter,
the counterpart of fenerf_tpu/data/native_loader.py without libjpeg,
libpng or PIL.

The library is built at first use with the host C++ compiler ($CXX, else
c++) into build/ (gitignored), once per source content, as ops/build.py
builds the kernels. A failed build raises: nothing falls back to another
decoder. Each decode call drops the GIL (ctypes), so threads of one
process can decode files in parallel, as eval/fid.py's real dump does;
the training loader decodes in worker processes (data/celeba_mask.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).with_name("native") / "codec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
JPEG_MAGIC = b"\xff\xd8"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_ERR_LEN = 512


def _so_path() -> Path:
    tag = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"fenerf_codec_{tag}.so"


def command(out: Path) -> list[str]:
    """The compiler command that builds the codec into `out`."""
    return [os.environ.get("CXX", "c++"), "-O3", "-shared", "-fPIC",
            "-std=c++17", str(SRC), "-o", str(out)]


def library() -> ctypes.CDLL:
    """The loaded codec, built first if needed; raises if the build fails."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = _so_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(command(tmp), capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {SRC.name} failed ({proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.fenerf_jpeg_info.restype = ctypes.c_int
        lib.fenerf_jpeg_info.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ip, ip, ip, ctypes.c_char_p,
            ctypes.c_int]
        lib.fenerf_jpeg_decode.restype = ctypes.c_int
        lib.fenerf_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, u8p, ctypes.c_char_p,
            ctypes.c_int]
        lib.fenerf_png_unfilter.restype = ctypes.c_int
        lib.fenerf_png_unfilter.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p]
        _LIB = lib
        return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Baseline JPEG bytes -> uint8 (H, W) grey or (H, W, 3) RGB, as PIL
    (libjpeg's islow IDCT, fancy upsampling, fixed-point colour) decodes
    them. Other JPEG kinds raise ValueError naming what is missing."""
    lib = library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.fenerf_jpeg_info(data, len(data), ctypes.byref(w),
                            ctypes.byref(h), ctypes.byref(c), err,
                            _ERR_LEN) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, 3)
    out = np.empty(shape, np.uint8)
    if lib.fenerf_jpeg_decode(data, len(data), _u8(out), err, _ERR_LEN) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def unfilter_png(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(rows, 1 + stride) filtered PNG scanlines -> (rows, stride) bytes
    (filter types None, Sub, Up, Average, Paeth)."""
    raw = np.ascontiguousarray(raw, np.uint8)
    rows, stride = raw.shape[0], raw.shape[1] - 1
    out = np.empty((rows, stride), np.uint8)
    rc = library().fenerf_png_unfilter(_u8(raw), rows, stride, bpp, _u8(out))
    if rc != 0:
        raise ValueError(f"unknown PNG filter type {int(raw[-rc - 1, 0])} "
                         f"on row {-rc - 1}")
    return out


def read_image(path: str, mode: str = "RGB") -> np.ndarray:
    """A JPEG or PNG file as PIL's Image.open(path).convert(mode) gives it,
    mode "RGB" (H, W, 3) or "L" (H, W) uint8."""
    from fenerf_tpu_torch.utils.image import read_png, to_mode

    with open(path, "rb") as f:
        data = f.read()
    img = decode_jpeg(data, path) if data[:2] == JPEG_MAGIC else read_png(path)
    return to_mode(img, mode)

