"""What the per-layer readers share: kernel names, required work over the
traced stretch, shares of the published peaks."""
from __future__ import annotations

from benchmark.harness import trace

# the port's kernels by the names their .cu files give them
FILM_MLP = ("film_mlp_kernel",)
FILM_MLP_BWD = ("bwd_rows_kernel", "dw_kernel", "reduce_kernel")
# cuDNN's convolution kernels (scripts/profile_torch_train.py's group)
CONV = ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad", "fprop",
        "nchw", "nhwc")
_PORT = FILM_MLP + FILM_MLP_BWD + ("ray_resample_kernel",
                                   "ray_finalize_kernel", "fold_zexp_kernel")


def _bare(name: str) -> str:
    """A demangled kernel name without its return type and the anonymous
    namespace the port's .cu files put their kernels in."""
    n = name.strip()
    n = n[5:] if n.startswith("void ") else n
    anon = "(anonymous namespace)::"
    return n[len(anon):] if n.startswith(anon) else n


def is_kernel(name: str, functions) -> bool:
    """A device op that is one of the port's kernels `functions` (by its
    unqualified function name: at::native::reduce_kernel is not the
    backward's reduce_kernel)."""
    n = _bare(name)
    return any(n == f or n.startswith((f + "(", f + "<")) for f in functions)


def is_conv(name: str) -> bool:
    return not is_kernel(name, _PORT) and any(p in name.lower()
                                              for p in CONV)


def device_time(tl: trace.Timeline, match) -> tuple[float, int]:
    """(seconds, count) of the window's device ops for which match(name)."""
    total, count = 0.0, 0
    for n, s, e in trace.clip(tl.device, tl.start, tl.end):
        if match(n):
            total += e - s
            count += 1
    return total / 1e6, count


def least_seconds(flops: float, nbytes: float, peaks: dict,
                  precision: str = "bfloat16") -> float:
    """The roofline's least time: the larger of the operations at the
    precision's peak and the bytes at the memory's."""
    return max(flops / peaks["peak_flops"][precision],
               nbytes / peaks["hbm_bytes_per_s"])


def peak_share(ops: dict, seconds: float, peaks: dict) -> float:
    """sum over precisions of ops / peak, over `seconds`, in %."""
    need = sum(n / peaks["peak_flops"][p] for p, n in ops.items())
    return 100.0 * need / seconds
