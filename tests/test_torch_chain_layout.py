"""The wgmma chains' weight layout (fenerf_tpu_torch/ops/mxu_chain.py::
pack_chain_weights, the plain version of ops/csrc/chain_pack.cuh's pack
kernel, which mxu_chain.cu and mxu_wide.cu launch), checked on the CPU
without the card: the swizzled chunks that the kernels copy with one bulk
copy each give back W, and with fold bf16(W * bf16(f)) and f * b + p, bit
for bit, at every width the kernels take; and run_wide's shared-memory
layout (mxu_wide.cu::make_layout, mirrored by wide_smem / wide_stages).

The un-swizzle here is written from the wgmma layout (128-byte rows of 64
K values, 16-byte group q of row r at position q ^ (r % 8)), not from the
pack's own index. The card test holding the pack kernel's bytes equal to
these is in tests/test_torch_kernel_cuda.py.
"""
import numpy as np
import pytest
import torch

from fenerf_tpu_torch.ops import mxu_chain as mc

LAYERS = 2


def _unswizzle(wdev: np.ndarray, layers: int, h: int) -> np.ndarray:
    """(layers, K = h, N = h) from the device layout: per layer, passes of
    128 output columns over the width padded to a multiple of 128, each cut
    into 64-row K chunks of 128 rows (one per output column) of 64 K
    values; assert that the padded columns hold zeros."""
    hd = -(-h // 128) * 128
    kch = h // 64
    chunks = wdev.reshape(layers, hd // 128, kch, 128, 64)
    out = np.zeros((layers, h, hd), dtype=wdev.dtype)
    for r in range(128):
        for pos in range(8):
            k0 = 8 * (pos ^ (r % 8))
            for c in range(kch):
                for p in range(hd // 128):
                    out[:, c * 64 + k0:c * 64 + k0 + 8, p * 128 + r] = \
                        chunks[:, p, c, r, 8 * pos:8 * pos + 8]
    assert not out[:, :, h:].any()
    return out[:, :, :h]


def _inputs(h: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn(LAYERS, h, h, generator=gen).bfloat16()
    b, f, p = (torch.randn(LAYERS, h, generator=gen) for _ in range(3))
    return w, b, f * 15 + 30, p


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("h", [64, 128, 192, 256, 320, 384, 448, 512])
def test_chain_device_layout_unswizzles_to_the_weights(h, fold):
    w, b, f, p = _inputs(h, seed=h + fold)
    wdev, q = mc.pack_chain_weights(w, b, f, p, fold=fold)
    assert wdev.dtype == torch.bfloat16
    assert wdev.numel() == LAYERS * mc.padded_width(h) * h
    want = w
    if fold:
        # the scaled weights: the product of two bf16 values is exact in
        # f32, rounded once to bf16
        scale = f.bfloat16().float()[:, None, :]
        want = (w.float() * scale).bfloat16()
        np.testing.assert_array_equal(q.numpy(), (f * b + p).numpy())
    else:
        assert q is None
    np.testing.assert_array_equal(_unswizzle(_bits(wdev), LAYERS, h),
                                  _bits(want))



@pytest.mark.parametrize("tile", mc.WIDE_TILES)
@pytest.mark.parametrize("h", [64, 128, 192, 256, 320, 384, 448, 512])
def test_wide_layout_fits_a_cta(h, tile):
    """run_wide's CTA: mbarriers (1 KB), weight stages of 16 KB and the two
    consumers' 64-row A tiles of h bf16 columns, with 1 KB of alignment
    slack, within a CTA's 227 KB; the stages as many as fit, at most 8, and
    at tile 64 (two rings) still two per ring."""
    stages = mc.wide_stages(h)
    a_tiles = 2 * 64 * h * 2
    assert mc.wide_smem(h) == 1024 + stages * 16384 + a_tiles + 1024
    assert mc.wide_smem(h) <= mc.MAX_SMEM
    assert stages == mc.MAX_STAGES or mc.wide_smem(h) + 16384 > mc.MAX_SMEM
    rings = 2 if tile == 64 else 1
    assert stages // rings >= 2 and stages >= mc.WIDE_MIN_STAGES
