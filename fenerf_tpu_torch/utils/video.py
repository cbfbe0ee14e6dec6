"""Uncompressed RIFF AVI in the standard library and numpy.

The JAX package writes its videos as mp4 through cv2's VideoWriter
(fenerf_tpu/utils/image.py::write_mp4); the port's machines need not have
cv2 or any encoder, so the port writes the same frames as an uncompressed
AVI: one video stream of BI_RGB 24-bit frames ('00db' chunks: BGR, each
row padded to 4 bytes) in the hdrl / strl / movi / idx1 layout. The rows
are stored top-down, which a negative biHeight declares: cv2 5.0's FFmpeg
reader corrupts its heap on bottom-up frames (their negative line size),
and reads top-down ones exactly. read_avi reads both orders back.
"""
from __future__ import annotations

import os
import struct

import numpy as np

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10


def _chunk(fourcc: bytes, data: bytes) -> bytes:
    pad = b"\0" if len(data) % 2 else b""
    return fourcc + struct.pack("<I", len(data)) + data + pad


def _list(kind: bytes, body: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", len(body) + 4) + kind + body


def _frame_bytes(frame: np.ndarray) -> bytes:
    """(H, W, 3) RGB uint8 -> the DIB rows: top-down, BGR, each row padded
    to a multiple of 4 bytes."""
    h, w, _ = frame.shape
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = frame[:, :, ::-1].reshape(h, 3 * w)
    return rows.tobytes()


def write_avi(path: str, frames, fps: int = 12) -> None:
    """(H, W, 3) uint8 RGB frames, all of one size -> an uncompressed AVI
    at `fps` frames per second."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("write_avi: no frames")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.shape != (h, w, 3) or f.dtype != np.uint8:
            raise ValueError(f"write_avi: frame {f.shape} {f.dtype}, not "
                             f"({h}, {w}, 3) uint8")
    size = (3 * w + 3) // 4 * 4 * h
    n = len(frames)
    avih = struct.pack("<10I4I", round(1e6 / fps), size * fps, 0,
                       _AVIF_HASINDEX, n, 0, 1, size, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sI2H8I4h", b"vids", b"DIB ", 0, 0, 0, 0, 1, fps,
                       0, n, size, 0xFFFFFFFF, 0, 0, 0, w, h)
    # biHeight -h: top-down rows
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, size, 0, 0, 0,
                       0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(
        b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    body, index = [], []
    offset = 4   # idx1 offsets count from the 'movi' fourcc
    for f in frames:
        c = _chunk(b"00db", _frame_bytes(f))
        index.append(struct.pack("<4sIII", b"00db", _AVIIF_KEYFRAME, offset,
                                 size))
        body.append(c)
        offset += len(c)
    movi = _list(b"movi", b"".join(body))
    idx1 = _chunk(b"idx1", b"".join(index))
    riff_body = b"AVI " + hdrl + movi + idx1
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(riff_body)) + riff_body)
    os.replace(tmp, path)


def _walk(data: bytes, start: int, end: int):
    """(fourcc, list kind or None, body start, body end) of the chunks in
    data[start:end]."""
    pos = start
    while pos + 8 <= end:
        fourcc = data[pos:pos + 4]
        (n,) = struct.unpack("<I", data[pos + 4:pos + 8])
        body = pos + 8
        if fourcc in (b"LIST", b"RIFF"):
            yield fourcc, data[body:body + 4], body + 4, body + n
        else:
            yield fourcc, None, body, body + n
        pos = body + n + (n % 2)


def read_avi(path: str) -> tuple[np.ndarray, float]:
    """An uncompressed 24-bit AVI -> ((N, H, W, 3) uint8 RGB frames, fps)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not a RIFF AVI")
    w = h = None
    fps = None
    frames = []

    def visit(start, end):
        nonlocal w, h, fps
        for fourcc, kind, b0, b1 in _walk(data, start, end):
            if kind is not None:
                visit(b0, b1)
            elif fourcc == b"strh":
                scale, rate = struct.unpack("<II", data[b0 + 20:b0 + 28])
                fps = rate / scale
            elif fourcc == b"strf":
                _, w, h, _, bits, comp = struct.unpack(
                    "<IiiHHI", data[b0:b0 + 20])
                if bits != 24 or comp != 0:
                    raise ValueError(f"{path}: {bits}-bit, compression "
                                     f"{comp}: only BI_RGB 24-bit is read")
            elif fourcc[2:] in (b"db", b"dc") and fourcc[:2].isdigit():
                stride = (3 * w + 3) // 4 * 4
                rows = np.frombuffer(data[b0:b1], np.uint8).reshape(
                    abs(h), stride)[:, :3 * w].reshape(abs(h), w, 3)
                if h > 0:                       # bottom-up
                    rows = rows[::-1]
                frames.append(rows[:, :, ::-1])

    visit(12, len(data))
    if not frames:
        raise ValueError(f"{path}: no video frames")
    return np.ascontiguousarray(np.stack(frames)), fps
