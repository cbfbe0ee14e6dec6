// The field's 512-wide ceiling probe for NVIDIA Hopper (sm_90a): the bf16
// chain a <- bf16(a @ W[i]) at width 512, the FLOPs per point of the
// 11-layer chain at 256 in 5 wider products.
//
// Replaces the Pallas TPU kernel scripts/profile_mxu_chain.py::run_wide
// (pallas_call at :102).
//
// What bounds it on the card: operations. 2 * n * h^2 * layers FLOPs
// against 2 * n * h * 2 bytes of activations in and out; at n = 2^19,
// h = 512, 5 layers that is 1.37 TFLOP against 1.07 GB, far above the
// H100's ~295 FLOP/byte ridge.
//
// Design: chain.cuh's run_tile on nvcuda::wmma, one CTA of 8 warps per tile
// of 32, 64 or 128 rows (128 does not fit at width 512). A wgmma version
// needs its A operand from shared memory at this width (a 64 x 512 bf16
// tile is 256 registers a thread); run_chain's wgmma kernel (mxu_chain.cu)
// holds it in registers up to width 256.
//
// The plain torch version is fenerf_tpu_torch/ops/mxu_chain.py::
// chain_reference.

#include "chain.cuh"

namespace {

using chain::bf16;

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
wide_kernel(chain::Params P, int tile) {
  extern __shared__ __align__(128) unsigned char smem[];
  const chain::Layout L = chain::group_layout(tile, P.h, THREADS / 32);
  const int row0 = blockIdx.x * tile;
  chain::run_tile(P, row0, tile, smem, L, threadIdx.x, THREADS / 32, 1);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA (ops/mxu_chain.py::wide_smem mirrors it).
int mxu_wide_smem(int tile, int h) {
  return chain::group_layout(tile, h, THREADS / 32).total;
}

// x (n, h) bf16 through `layers` layers of w (layers, h, h) bf16 into out
// (n, h) bf16, `tile` rows (32, 64 or 128) per CTA. Launches on `stream`;
// returns cudaGetLastError() (0 = launched).
int mxu_wide_forward(const void* x, const void* w, void* out, int n, int h,
                     int layers, int tile, void* stream) {
  if ((tile != 32 && tile != 64 && tile != 128) || h % 64 != 0 || n < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = mxu_wide_smem(tile, h);
  if (smem > chain::MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  chain::Params P{(const bf16*)x, (const bf16*)w, (bf16*)out, n, h, layers};
  wide_kernel<<<(n + tile - 1) / tile, THREADS, smem, (cudaStream_t)stream>>>(
      P, tile);
  return (int)cudaGetLastError();
}

const char* mxu_wide_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
