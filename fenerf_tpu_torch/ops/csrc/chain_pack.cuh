// The weights' device layout of the wgmma chains, mxu_chain.cu (widths up
// to 256) and mxu_wide.cu (up to 512), and the pack kernel that writes it.
//
// (layers, h, h) row-major bf16 -> per layer, per 128-column pass of the
// padded width, per 64-row K chunk: 128 rows (one per output column n) of
// 64 K values, the 16-byte group q of row r holding K values
// 8 * (q ^ (r % 8)) .. + 8 of the chunk: wgmma's 128-byte-swizzled K-major
// B operand (hopper.cuh), one contiguous 16 KB chunk for one bulk copy.
// The output columns are padded to a multiple of 128 with zero weights
// (the padded columns are never read again nor stored). With fold the
// weights are bf16(W * bf16(f)) per output column and q = f * b + p.
//
// The plain torch version is fenerf_tpu_torch/ops/mxu_chain.py::
// pack_chain_weights (the same bytes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace chain_pack {

typedef __nv_bfloat16 bf16;

constexpr int PASS = 128;     // output columns per pass
constexpr int KCHUNK = 64;    // K rows per weight chunk

__host__ __device__ inline int padded(int h) {
  return (h + PASS - 1) / PASS * PASS;
}

// One thread per 16-byte group, consecutive threads on consecutive n.
__global__ void pack_kernel(const bf16* __restrict__ w,
                            const float* __restrict__ b,
                            const float* __restrict__ f,
                            const float* __restrict__ p, int h, int layers,
                            int fold, bf16* __restrict__ wdev,
                            float* __restrict__ q) {
  const int hd = padded(h), kch = h / KCHUNK, passes = hd / PASS;
  const size_t groups = (size_t)layers * hd * h / 8;
  const size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < groups;
       i += step) {
    const int r = (int)(i % PASS);
    const int qg = (int)(i / PASS % 8);
    const size_t chunk = i / (PASS * 8);
    const int c = (int)(chunk % kch);
    const size_t lp = chunk / kch;
    const int pass = (int)(lp % passes);
    const int l = (int)(lp / passes);
    const int n = pass * PASS + r;
    const int k0 = c * KCHUNK + 8 * (qg ^ (r & 7));
    __align__(16) bf16 v[8];
    if (n < h) {
      const bf16* src = w + ((size_t)l * h + k0) * h + n;
      const float fb = fold ? __bfloat162float(__float2bfloat16_rn(
                                  f[(size_t)l * h + n]))
                            : 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bf16 x = src[(size_t)e * h];
        v[e] = fold ? __float2bfloat16_rn(__fmul_rn(__bfloat162float(x), fb))
                    : x;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16_rn(0.f);
    }
    *reinterpret_cast<int4*>(wdev + chunk * PASS * KCHUNK + r * KCHUNK + 8 * qg) =
        *reinterpret_cast<const int4*>(v);
  }
  if (fold) {
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < (size_t)layers * h; i += step)
      q[i] = __fadd_rn(__fmul_rn(f[i], b[i]), p[i]);
  }
}

}  // namespace chain_pack
