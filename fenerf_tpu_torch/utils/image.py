"""Image helpers of the port's apps (its own copy of the numpy parts of
fenerf_tpu/utils/image.py, plus what the card's machine lacks): the 19-class
CelebAMask-HQ palette, label-map colouring, float-to-uint8, grids and grid
PNGs, the jet depth colouring, a zlib PNG writer and reader (its scanlines
unfiltered by the native codec, data/native_loader.py) and PIL-exact
resizes, so that no app needs PIL or cv2.
"""
from __future__ import annotations

import functools
import math
import os
import struct
import zlib

import numpy as np

# index 0 = background
CELEBA_PALETTE = np.array([
    [0, 0, 0], [204, 0, 0], [76, 153, 0], [204, 204, 0], [51, 51, 255],
    [204, 0, 204], [0, 255, 255], [255, 204, 204], [102, 51, 0], [255, 0, 0],
    [102, 204, 0], [255, 255, 0], [0, 0, 153], [0, 0, 204], [255, 51, 153],
    [0, 204, 204], [0, 51, 0], [255, 153, 51], [0, 204, 0],
], dtype=np.uint8)

# cv2.COLORMAP_JET as RGB rows, level 0 first (the table cv2.applyColorMap
# reads for an 8-bit input)
JET = np.frombuffer(bytes.fromhex(
    "00008000008400008800008c00009000009400009800009c0000a00000a40000a80000ac"
    "0000b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc"
    "0000e00000e40000e80000ec0000f00000f40000f80000fc0000ff0004ff0008ff000cff"
    "0010ff0014ff0018ff001cff0020ff0024ff0028ff002cff0030ff0034ff0038ff003cff"
    "0040ff0044ff0048ff004cff0050ff0054ff0058ff005cff0060ff0064ff0068ff006cff"
    "0070ff0074ff0078ff007cff0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff"
    "00a0ff00a4ff00a8ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff"
    "00d0ff00d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2affd62effd2"
    "32ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56ffaa5affa65effa2"
    "62ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff8282ff7e86ff7a8aff768eff72"
    "92ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff56aeff52b2ff4eb6ff4abaff46beff42"
    "c2ff3ec6ff3acaff36ceff32d2ff2ed6ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12"
    "f2ff0ef6ff0afaff06feff01fffc00fff800fff400fff000ffec00ffe800ffe400ffe000"
    "ffdc00ffd800ffd400ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000"
    "ffac00ffa800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff5400ff5000"
    "ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff2800ff2400ff2000"
    "ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000fc0000f80000f40000f00000"
    "ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c00000"
    "bc0000b80000b40000b00000ac0000a80000a40000a000009c0000980000940000900000"
    "8c0000880000840000800000"
), np.uint8).reshape(256, 3)


def mask2color(labels: np.ndarray) -> np.ndarray:
    """(B, C, H, W) label logits / one-hot -> (B, H, W, 3) uint8 palette RGB
    of the argmax class."""
    idx = np.argmax(np.asarray(labels), axis=1)
    return CELEBA_PALETTE[idx % len(CELEBA_PALETTE)]


def to_uint8(img: np.ndarray, normalize: bool = True) -> np.ndarray:
    """(..., H, W) float in [-1, 1] (or min-max normalized) -> uint8."""
    img = np.asarray(img, dtype=np.float32)
    if normalize:
        lo, hi = img.min(), img.max()
        img = (img - lo) / max(hi - lo, 1e-8)
    else:
        img = (img + 1.0) / 2.0
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 5, pad: int = 2) -> np.ndarray:
    """(N, H, W, 3) uint8 -> one grid image (like torchvision make_grid)."""
    n, h, w, c = images.shape
    nrows = math.ceil(n / nrow)
    grid = np.zeros((nrows * (h + pad) + pad, nrow * (w + pad) + pad, c),
                    dtype=images.dtype)
    for i in range(n):
        r, col = divmod(i, nrow)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y:y + h, x:x + w] = images[i]
    return grid


def depth_to_jet(depth: np.ndarray, lo=0.88, hi=1.12) -> np.ndarray:
    """Depth map -> jet colormap uint8 RGB: the levels of
    cv2.applyColorMap(..., COLORMAP_JET), read from its table."""
    d = np.clip((np.asarray(depth) - lo) / max(hi - lo, 1e-8), 0, 1)
    return JET[(d * 255).astype(np.uint8)]


# ---------------------------------------------------------------------------
# PNG: a zlib writer and an 8-bit non-interlaced reader
# ---------------------------------------------------------------------------

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (grey, RGB, palette index, RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB or (H, W) uint8 grey -> PNG bytes (8-bit, no
    filtering, zlib)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img, color = img[..., None], 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"encode_png takes (H, W, 3) or (H, W) images, got "
                         f"{img.shape}")
    h, w, c = img.shape
    raw = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0 per scanline
    raw[:, 1:] = img.reshape(h, w * c)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (PNG_MAGIC
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) RGB or (H, W) grey uint8 image as a PNG."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(img))


def save_image_grid(path: str, chw_batch: np.ndarray, nrow: int = 5,
                    normalize: bool = True) -> None:
    """(N, 3, H, W) float -> a grid PNG (the reference's save_image(...,
    nrow=5))."""
    imgs = to_uint8(np.asarray(chw_batch), normalize).transpose(0, 2, 3, 1)
    save_png(path, make_grid(imgs, nrow=nrow))


def _unfilter_slow(kind: int, line: bytearray, prior: bytes, bpp: int):
    """Average (3) and Paeth (4) scanlines, byte by byte in place (each byte
    depends on the one reconstructed bpp to its left)."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            line[i] = (line[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def unfilter_rows(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(rows, 1 + stride) filtered scanlines -> (rows, stride) bytes in
    numpy and Python: the plain version of the native unfilter
    (data/native_loader.py::unfilter_png) that read_png uses."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    w = stride // bpp
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:     # Sub: running sum per channel, mod 256
            cur = (np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.int64)
                   .astype(np.uint8).reshape(stride))
        elif kind == 2:     # Up
            cur = line + prior
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            _unfilter_slow(kind, buf, prior.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {kind} on row {y}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced grey, RGB, RGBA or palette PNG ->
    uint8 (H, W) grey, (H, W, 3) RGB (palette images too, through their
    palette) or (H, W, 4) RGBA. Any other PNG, or another format, raises
    ValueError. The scanlines are unfiltered by the native codec
    (data/native_loader.py::unfilter_png)."""
    from fenerf_tpu_torch.data.native_loader import unfilter_png

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG (only PNG images are read)")
    pos, idat, hdr, palette = 8, [], None, None
    while pos + 8 <= len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{color}, interlace {interlace}); 8-bit non-interlaced grey, "
            f"RGB, RGBA and palette images are read")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    bpp = _PNG_CHANNELS[color]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of pixel data, expected "
                         f"{h * (stride + 1)}")
    out = unfilter_png(raw.reshape(h, stride + 1), bpp)
    if color == 0:
        return out
    if color == 3:
        if out.max() >= len(palette):
            raise ValueError(f"{path}: palette index outside the palette")
        return palette[out]
    return out.reshape(h, w, bpp)


def to_mode(img: np.ndarray, mode: str) -> np.ndarray:
    """PIL's Image.convert to "RGB" or "L" on a read_png array: grey is
    repeated to RGB, alpha dropped, and RGB weighted to L by ITU-R 601-2 in
    PIL's fixed point ((19595 R + 38470 G + 7471 B + 0x8000) >> 16)."""
    img = np.asarray(img, np.uint8)
    if mode == "RGB":
        if img.ndim == 2:
            return np.repeat(img[..., None], 3, axis=-1)
        return np.ascontiguousarray(img[..., :3])
    if mode == "L":
        if img.ndim == 2:
            return img
        c = img[..., :3].astype(np.uint32)
        return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
                 + 0x8000) >> 16).astype(np.uint8)
    raise ValueError(f"unknown mode {mode!r}")


# ---------------------------------------------------------------------------
# Resize with PIL's semantics (Image.resize on "L" and "RGB" images)
# ---------------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2


@functools.lru_cache(maxsize=None)
def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """PIL's NEAREST source index: floor((x + 0.5) * scale), with the
    position advanced by repeated double additions as PIL does."""
    scale = n_in / n_out
    pos = scale * 0.5
    idx = np.empty(n_out, np.int64)
    for x in range(n_out):
        idx[x] = min(int(pos), n_in - 1)
        pos += scale
    idx.flags.writeable = False   # cached: shared by every caller
    return idx


def _triangle(x: float) -> float:
    """PIL's bilinear filter."""
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    """PIL's Lanczos filter: sinc truncated to [-3, 3) by sinc(x / 3)."""
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3.0)
    return 0.0


# PIL's resampling filters and their supports
_FILTERS = {"bilinear": (_triangle, 1.0), "lanczos": (_lanczos, 3.0)}


@functools.lru_cache(maxsize=None)
def _coeffs(n_in: int, n_out: int, method: str):
    """PIL's precompute_coeffs for a filter of _FILTERS, in its fixed
    point: -> (first source index (n_out,), int64 weights (n_out, k)).
    The support widens by the scale factor when downscaling."""
    fn, base = _FILTERS[method]
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = base * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(n_out, np.int64)
    kk = np.zeros((n_out, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        ws = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in ws:
            ww += w
        for x, w in enumerate(ws):
            w = w / ww if ww != 0.0 else w
            kk[xx, x] = int((-0.5 if w < 0 else 0.5)
                            + w * (1 << _PRECISION_BITS))
        first[xx] = xmin
    first.flags.writeable = kk.flags.writeable = False   # cached
    return first, kk


def _resample_pass(img: np.ndarray, n_out: int, axis: int,
                   method: str) -> np.ndarray:
    """One of PIL's two 8-bit passes along `axis`: the fixed-point
    weighted sum, rounded by adding half and shifting, clipped to uint8."""
    n_in = img.shape[axis]
    first, kk = _coeffs(n_in, n_out, method)
    # int32 holds every sum: 255 * (sum of a row's |weights|, ~2^22) + 2^21
    assert 255 * int(np.abs(kk).sum(axis=1).max()) + (1 << 21) < 2 ** 31
    # the resized axis first and contiguous: each tap gathers whole rows
    src = np.ascontiguousarray(np.moveaxis(img, axis, 0), dtype=np.int32)
    shape = (n_out,) + (1,) * (src.ndim - 1)
    acc = None
    for k in range(kk.shape[1]):
        idx = np.minimum(first + k, n_in - 1)
        term = src[idx]
        term *= kk[:, k].astype(np.int32).reshape(shape)
        if acc is None:
            acc = term
        else:
            acc += term
    acc += 1 << (_PRECISION_BITS - 1)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def resize(img: np.ndarray, size: tuple, method: str = "bilinear"
           ) -> np.ndarray:
    """PIL's Image.resize((w, h), NEAREST | BILINEAR | LANCZOS) on an
    (H, W) or (H, W, C) uint8 array, channel by channel. BILINEAR and
    LANCZOS run the horizontal pass, then the vertical one, each rounded
    to uint8, as PIL does."""
    img = np.asarray(img, np.uint8)
    w, h = size
    if (h, w) == img.shape[:2]:
        return img.copy()
    if method == "nearest":
        return img[_nearest_index(img.shape[0], h)][
            :, _nearest_index(img.shape[1], w)]
    if method not in _FILTERS:
        raise ValueError(f"unknown resize method {method!r}")
    if w != img.shape[1]:
        img = _resample_pass(img, w, 1, method)
    if h != img.shape[0]:
        img = _resample_pass(img, h, 0, method)
    return img


def quad_transform(img: np.ndarray, size: tuple, data) -> np.ndarray:
    """PIL's Image.transform((w, h), QUAD, data, BILINEAR) on an (H, W) or
    (H, W, C) uint8 array. data holds the source quad's corners NW, SW, SE,
    NE as 8 numbers; each output pixel centre maps bilinearly into it
    (PIL's coefficients and sum order, in float64). A source point outside
    the image gives 0; inside, PIL's bilinear filter samples the pixel
    centres around it, the columns and the first row clamped to the image,
    a second row below the last repeating the first, and truncates the
    result to uint8."""
    img = np.asarray(img, np.uint8)
    w, h = size
    x0, y0, swx, swy, sex, sey, nex, ney = (float(v) for v in data)
    a_s, a_t = 1.0 / w, 1.0 / h
    a = (x0, (nex - x0) * a_s, (swx - x0) * a_t,
         (sex - swx - nex + x0) * a_s * a_t,
         y0, (ney - y0) * a_s, (swy - y0) * a_t,
         (sey - swy - ney + y0) * a_s * a_t)
    xin = np.arange(w, dtype=np.float64)[None, :] + 0.5
    yin = np.arange(h, dtype=np.float64)[:, None] + 0.5
    xs = a[0] + a[1] * xin + a[2] * yin + a[3] * xin * yin
    ys = a[4] + a[5] * xin + a[6] * yin + a[7] * xin * yin
    hi, wi = img.shape[:2]
    inside = (xs >= 0.0) & (xs < wi) & (ys >= 0.0) & (ys < hi)
    xs = np.where(inside, xs, 0.5) - 0.5
    ys = np.where(inside, ys, 0.5) - 0.5
    xf, yf = np.floor(xs), np.floor(ys)
    dx, dy = xs - xf, ys - yf
    x, y = xf.astype(np.int64), yf.astype(np.int64)
    c0, c1 = np.clip(x, 0, wi - 1), np.clip(x + 1, 0, wi - 1)
    r0 = np.clip(y, 0, hi - 1)
    below = (y + 1 >= 0) & (y + 1 < hi)
    r1 = np.where(below, y + 1, r0)
    src = img.astype(np.float64)
    if src.ndim == 3:
        dx, dy = dx[..., None], dy[..., None]
        inside = inside[..., None]
    a0, a1 = src[r0, c0], src[r0, c1]
    v1 = a0 + (a1 - a0) * dx
    b0, b1 = src[r1, c0], src[r1, c1]
    v2 = b0 + (b1 - b0) * dx
    v = v1 + (v2 - v1) * dy
    return np.where(inside, v, 0.0).astype(np.uint8)
