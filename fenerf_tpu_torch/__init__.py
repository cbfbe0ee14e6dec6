"""fenerf_tpu_torch — the PyTorch / CUDA port of fenerf_tpu for NVIDIA Hopper.

The JAX package `fenerf_tpu` is the reference this package is held to: the
same module layout (core/, nn/, ops/, models/, apps/, compat/), the same
parameter layouts and the same `.npz` checkpoint format. Plain tensor code
is PyTorch; the fused FiLM-SIREN field (the Pallas kernel of
fenerf_tpu/ops/film_mlp.py) is a hand-written sm_90a CUDA kernel
(ops/csrc/film_mlp.cu), built at first use.

This package imports neither JAX nor anything of fenerf_tpu, not even a
module there that is free of JAX: what it needs, it keeps its own copy of.
Only the parity tests import both packages.
"""

__version__ = "0.1.0"
