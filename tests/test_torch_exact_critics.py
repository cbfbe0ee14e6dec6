"""The critics' convolutions run with cuDNN's TF32 off in every direction
under the trainer: one train_step of the flagship curriculum at tiny
widths, with the process's flag left at torch's default (on), records the
flag at every convolution and convolution backward that aten runs
(a TorchDispatchMode); each must see it off, in the phases' forwards, in
their backwards and in R1's double backward (convolutions run inside a
gradient computation), and the default must be back on afterwards. The
contexts of the precision policy (utils/precision.py) set and restore
their flags.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fenerf_tpu_torch.train import curriculum as tcur
from fenerf_tpu_torch.train import loop as tloop
from fenerf_tpu_torch.utils.precision import exact_convs, exact_matmuls

from test_torch_train_step import tiny_texture_meta

torch.set_num_threads(2)

CONV_OPS = {torch.ops.aten.convolution.default: "convolution",
            torch.ops.aten.convolution_backward.default: "backward"}


class _FlagLog(TorchDispatchMode):
    """(op, inside a gradient computation, cuDNN's allow_tf32) per call."""

    def __init__(self):
        super().__init__()
        self.calls = []
        self.in_grads = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in CONV_OPS:
            self.calls.append((CONV_OPS[func], self.in_grads,
                               torch.backends.cudnn.allow_tf32))
        return func(*args, **(kwargs or {}))


def test_train_step_keeps_tf32_off_in_the_critics(monkeypatch):
    meta = tiny_texture_meta(tcur)
    assert meta.r1_lambda > 0
    state = tloop.init_train_state(meta, seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    b, size = meta.batch_size, meta.img_size
    imgs = torch.rand(b, 3, size, size, generator=g) * 2 - 1
    labels = torch.rand(b, 18, size, size, generator=g) * 2 - 1
    log = _FlagLog()
    grads = tloop._grads

    def watched(loss, params):
        log.in_grads = True
        try:
            return grads(loss, params)
        finally:
            log.in_grads = False

    monkeypatch.setattr(tloop, "_grads", watched)
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with log:
            _, metrics = tloop.train_step(
                state, imgs, labels,
                tloop.StepScalars(alpha=1.0, noise_std=0.0, topk_frac=1.0),
                meta, generator=g)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = old
    assert np.isfinite(float(metrics["g_loss"]))
    kinds = {(op, in_grads) for op, in_grads, _ in log.calls}
    # forwards, backwards (R1's input gradient among them), and
    # convolutions inside a gradient computation: R1's double backward
    assert kinds >= {("convolution", False), ("backward", True),
                     ("convolution", True)}, kinds
    on = [c for c in log.calls if c[2]]
    assert not on, f"{len(on)} of {len(log.calls)} with TF32 allowed: " \
        f"{sorted(set(on))}"


@pytest.mark.parametrize("deterministic", [True, False])
def test_exact_convs_turns_tf32_off_and_restores(deterministic):
    """utils/precision.py::exact_convs: TF32 off inside; deterministic
    algorithms without benchmarking when asked, else the process's choice;
    every flag back as it was after."""
    cudnn = torch.backends.cudnn
    kept = (cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic,
            cudnn.enabled)
    cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic = True, True, False
    try:
        with exact_convs(deterministic=deterministic):
            assert not cudnn.allow_tf32 and cudnn.enabled
            assert cudnn.deterministic == deterministic
            assert cudnn.benchmark == (not deterministic)
        assert (cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic) == (
            True, True, False)
    finally:
        (cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic,
         cudnn.enabled) = kept


def test_exact_matmuls_restores_the_flag():
    matmul = torch.backends.cuda.matmul
    kept = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        with exact_matmuls():
            assert not matmul.allow_tf32
        assert matmul.allow_tf32
        with pytest.raises(ValueError), exact_matmuls():
            raise ValueError
        assert matmul.allow_tf32
    finally:
        matmul.allow_tf32 = kept
