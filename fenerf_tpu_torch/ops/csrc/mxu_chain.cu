// The field's ceiling probes for NVIDIA Hopper (sm_90a): a pure bf16 chain
// of products, and the same chain with the FiLM / sine epilogue.
//
// Replaces the Pallas TPU kernels scripts/profile_mxu_chain.py::run_chain
// (pallas_call at :73) and ::run_wide (:102), and
// scripts/profile_epilogue_overlap.py::run_epi (:88). They measure what
// bounds the fused field kernel (ops/csrc/film_mlp.cu): its chain of
// 256-wide products alone (run_chain; run_wide at width 512 with the same
// FLOPs per point), or the chain plus the f32 epilogue on the CUDA cores
// (run_epi; with fold, the FiLM scale folded into the weights so the
// epilogue is one add and the sine).
//
// What bounds them on the card: 2 * n * h^2 * layers FLOPs against
// 2 * n * h * 2 bytes of activations in and out (the weights, 1.4 MB, are
// read from L2 by every CTA); at n = 2^20, h = 256, 11 layers that is
// 1.51 TFLOP against 1.07 GB, far above the H100's ~295 FLOP/byte ridge:
// tensor-core throughput and the shared-memory traffic that feeds it bound
// them. The epilogue adds ~12 f32 instructions per output element on the
// CUDA cores (bias add, FiLM multiply-add, the reduction's multiply, rint,
// multiply, subtract, the square, 4 multiply-adds and a multiply of the
// polynomial, the bf16 conversion), which either hide under the products
// or add to them: that is what run_epi measures.
//
// Design: chain.cuh's run_tile. One CTA of 8 warps per tile of 32, 64 or
// 128 rows, split into `groups` (1, 2 or 4) independent warp groups of
// tile / groups rows each: the TPU kernel's k-way interleave, read on the
// card as independent row sub-tiles whose layers the warp schedulers issue
// alternately (each group stages its own weights, so k groups read the
// weights k times from L2). fold = True first forms bf16(W * bf16(f)) and
// f * b + p once per call in a small kernel (the TPU kernel formed them
// once per tile), then runs the chain with the one-add epilogue.
//
// The plain torch versions are fenerf_tpu_torch/ops/mxu_chain.py::
// chain_reference and epi_reference.

#include "chain.cuh"

namespace {

using chain::bf16;

constexpr int THREADS = 256;

template <int EPI>
__global__ void __launch_bounds__(THREADS)
chain_kernel(chain::Params P, int tile, int groups) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = (THREADS / 32) / groups, rows = tile / groups;
  const chain::Layout L = chain::group_layout(rows, P.h, warps);
  const int grp = threadIdx.x / (warps * 32);
  const int row0 = blockIdx.x * tile + grp * rows;
  if (row0 >= P.n) return;  // the whole group lies past the end
  chain::run_tile<EPI>(P, row0, rows, smem + grp * L.total, L,
                       threadIdx.x - grp * warps * 32, warps, 1 + grp);
}

// fold: ws = bf16(w * bf16(f)) per output column, q = f * b + p (rounded
// as the plain version: product, then sum)
__global__ void fold_prep_kernel(const bf16* __restrict__ w,
                                 const float* __restrict__ b,
                                 const float* __restrict__ f,
                                 const float* __restrict__ p, int h,
                                 int layers, bf16* __restrict__ ws,
                                 float* __restrict__ q) {
  const size_t total = (size_t)layers * h * h;
  const size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += step) {
    const int c = (int)(i % h);
    const int l = (int)(i / ((size_t)h * h));
    const float fb = __bfloat162float(__float2bfloat16_rn(f[l * h + c]));
    ws[i] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(w[i]), fb));
  }
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < (size_t)layers * h; i += step)
    q[i] = __fadd_rn(__fmul_rn(f[i], b[i]), p[i]);
}

template <int EPI>
int launch(const chain::Params& P, int tile, int groups, int smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (P.n + tile - 1) / tile;
  chain_kernel<EPI><<<blocks, THREADS, smem, stream>>>(P, tile, groups);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA (ops/mxu_chain.py::chain_smem mirrors it).
int mxu_chain_smem(int tile, int groups, int h) {
  return groups *
         chain::group_layout(tile / groups, h, (THREADS / 32) / groups).total;
}

// x (n, h) bf16 through `layers` layers of w (layers, h, h) bf16 into out
// (n, h) bf16. epi: 0 none, 1 FiLM (b, f, p: (layers, h) f32), 2 fold (the
// same inputs; ws (layers, h, h) bf16 and q (layers, h) f32 are scratch).
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int mxu_chain_forward(const void* x, const void* w, const void* b,
                      const void* f, const void* p, void* ws, void* q,
                      void* out, int n, int h, int layers, int tile,
                      int groups, int epi, void* stream) {
  if (groups < 1 || tile < chain::WM * groups || tile % groups != 0 ||
      (tile / groups) % chain::WM != 0 || h % 64 != 0 ||
      ((THREADS / 32) / groups) % (tile / groups / chain::WM) != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = mxu_chain_smem(tile, groups, h);
  if (smem > chain::MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  chain::Params P{(const bf16*)x, (const bf16*)w, (const float*)b,
                  (const float*)f, (const float*)p, (bf16*)out, n, h, layers};
  if (epi == chain::EPI_NONE) return launch<chain::EPI_NONE>(P, tile, groups, smem, s);
  if (epi == chain::EPI_FILM) return launch<chain::EPI_FILM>(P, tile, groups, smem, s);
  if (epi != chain::EPI_FOLD) return (int)cudaErrorInvalidValue;
  fold_prep_kernel<<<264, 256, 0, s>>>(P.w, P.b, P.f, P.p, h, layers,
                                       (bf16*)ws, (float*)q);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  P.w = (const bf16*)ws;
  P.p = (const float*)q;
  return launch<chain::EPI_FOLD>(P, tile, groups, smem, s);
}

const char* mxu_chain_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
