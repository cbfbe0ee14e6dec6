"""Minimal MRC2014 volume writer and reader (the port's own copy of
fenerf_tpu/utils/mrc.py; no mrcfile needed).

The reference writes extracted sigma volumes with mrcfile.new_mmap
(extract_double_semantic_shapes.py:118-119, extract_shapes.py). The format is
a 1024-byte header followed by raw voxel data; mode 2 = float32. Readers
(ChimeraX, mrcfile, marching-cubes pipelines) consume this directly.
"""
from __future__ import annotations

import struct

import numpy as np


def write_mrc(path: str, volume: np.ndarray, voxel_size: float = 1.0) -> None:
    """Write (nz, ny, nx) float32 volume as MRC2014."""
    vol = np.ascontiguousarray(np.asarray(volume, dtype=np.float32))
    assert vol.ndim == 3, "volume must be 3D (nz, ny, nx)"
    nz, ny, nx = vol.shape

    header = bytearray(1024)
    def put_i32(off, v): struct.pack_into("<i", header, off, int(v))
    def put_f32(off, v): struct.pack_into("<f", header, off, float(v))

    put_i32(0, nx); put_i32(4, ny); put_i32(8, nz)
    put_i32(12, 2)                       # mode 2: float32
    put_i32(28, nx); put_i32(32, ny); put_i32(36, nz)   # mx, my, mz
    put_f32(40, nx * voxel_size); put_f32(44, ny * voxel_size)
    put_f32(48, nz * voxel_size)         # cell dimensions
    put_f32(52, 90.0); put_f32(56, 90.0); put_f32(60, 90.0)  # angles
    put_i32(64, 1); put_i32(68, 2); put_i32(72, 3)       # axis order
    put_f32(76, float(vol.min())); put_f32(80, float(vol.max()))
    put_f32(84, float(vol.mean()))
    header[208:212] = b"MAP "            # format id
    header[212:216] = bytes([0x44, 0x44, 0x00, 0x00])  # little-endian stamp
    put_f32(216, float(vol.std()))

    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(vol.tobytes())


def read_mrc(path: str) -> np.ndarray:
    """Read back a mode-2 MRC volume (for tests / downstream tools)."""
    with open(path, "rb") as f:
        header = f.read(1024)
        nx, ny, nz, mode = struct.unpack_from("<4i", header, 0)
        assert mode == 2, f"only mode 2 supported, got {mode}"
        data = np.frombuffer(f.read(nx * ny * nz * 4), dtype="<f4")
    return data.reshape(nz, ny, nx)
