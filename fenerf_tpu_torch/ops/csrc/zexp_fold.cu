// Texture-table cotangent fold for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fenerf_tpu/ops/zexp_fold.py::fold_zexp
// (pallas_call at zexp_fold.py:95): the adjoint of the z-expanded table build,
// a table cotangent ((D+1)(H+1)(W+1), 8C), f32 or bf16, folded into the grid
// gradient (C, D, H, W) in f32:
//   out[c, z, y, x] = sum_{k=0..7} dt[(z+1-dz, y+1-dy, x+1-dx), k*C + c],
//   k = dz*4 + dy*2 + dx,
// summed in f32 in the order k = 0..7, as the plain version
// (fenerf_tpu_torch/core/grid_sample.py::zexp_table_adjoint_torch) sums its
// eight slices, so the two agree bit for bit.
//
// What bounds it on the card: bytes. Each table element is read at most
// once (every output reads 8 distinct elements, no two outputs share one):
// 935 MB in and 113 MB out at the flagship 96^3 x 32 grid with an f32
// cotangent, ~0.31 ms at 3.35 TB/s.
//
// Design: the input is channel-minor and the output channel-major. A CTA
// takes one (z, y) and a tile of 32 x; it reads with threads over channels
// (each warp a contiguous run of C values of one table row), sums the eight
// terms in registers, transposes through a padded shared-memory tile and
// writes with threads over x. The TPU kernel's four partial outputs and
// one-hot selector matmuls were workarounds for its matrix unit and are not
// carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int XT = 32;        // x per CTA
constexpr int THREADS = 256;
constexpr int MAX_C = 256;    // shared tile: C x (XT + 1) floats

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    fold_zexp_kernel(const T* __restrict__ dt, float* __restrict__ out,
                     int c, int d, int h, int w) {
  extern __shared__ float tile[];  // [c][XT + 1]
  const int x0 = blockIdx.x * XT, y = blockIdx.y, z = blockIdx.z;
  const int nx = min(XT, w - x0);
  const int hp = h + 1, wp = w + 1;
  const size_t cols = (size_t)8 * c;
  for (int e = threadIdx.x; e < nx * c; e += THREADS) {
    const int ch = e % c, xi = e / c, x = x0 + xi;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int dz = (k >> 2) & 1, dy = (k >> 1) & 1, dx = k & 1;
      const size_t row =
          ((size_t)(z + 1 - dz) * hp + (y + 1 - dy)) * wp + (x + 1 - dx);
      const float v = to_f32(dt[row * cols + (size_t)k * c + ch]);
      acc = k == 0 ? v : acc + v;
    }
    tile[ch * (XT + 1) + xi] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nx * c; e += THREADS) {
    const int xi = e % nx, ch = e / nx;
    out[(((size_t)ch * d + z) * h + y) * w + x0 + xi] =
        tile[ch * (XT + 1) + xi];
  }
}

}  // namespace

extern "C" {

// Launches the fold on `stream` (dtable bf16 if is_bf16, else f32); returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for shapes it
// does not cover.
int fold_zexp_forward(const void* dtable, void* out, int c, int d, int h,
                      int w, int is_bf16, void* stream) {
  if (c < 1 || c > MAX_C || d < 1 || h < 1 || w < 1 || d > 65535 ||
      h > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + XT - 1) / XT, h, d);
  const size_t shmem = (size_t)c * (XT + 1) * sizeof(float);
  if (is_bf16)
    fold_zexp_kernel<__nv_bfloat16><<<grid, THREADS, shmem,
                                      (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)dtable, (float*)out, c, d, h, w);
  else
    fold_zexp_kernel<float><<<grid, THREADS, shmem, (cudaStream_t)stream>>>(
        (const float*)dtable, (float*)out, c, d, h, w);
  return (int)cudaGetLastError();
}

const char* zexp_fold_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
