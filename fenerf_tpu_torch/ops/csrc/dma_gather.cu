// Scattered-row gather for NVIDIA Hopper (sm_90a): out[i] = table[idx[i]],
// alone or overlapped in one kernel with the bf16 chain of chain.cuh.
//
// Replaces the Pallas TPU kernel scripts/profile_dma_gather.py::
// ring_dma_gather (pallas_call at :118): a ring of at most `ring` row
// copies in flight per tile of 1024 indices, and, with overlap, the
// 11-layer chain over the tile's rows of an (n, 256) activation in the
// same kernel. It probes whether the field's texture-row gather
// (core/grid_sample.py) could hide under the field's products.
//
// What bounds it on the card: bytes. Each index reads one row and writes
// one row, 2 * row_bytes + 4 bytes per index (1.07 GB at 2^18 indices of
// 2 KB rows: 0.32 ms at 3.35 TB/s); nothing is computed. The rows are
// scattered over a 1.87 GB table, so L2 does not help.
//
// Design (simple and right first):
//   * a CTA owns 1024 indices and loads them into shared memory itself
//     (the card has no scalar prefetch);
//   * each row is copied by a power-of-two team of threads in 16-byte
//     cp.async pieces into a shared ring slot; a thread keeps RW rows of
//     its own stream in flight (commit per row, wait RW - 1 groups behind),
//     then stores the pieces it copied itself (no barrier: cp.async data is
//     visible to the thread that waited for it). The CTA has ring =
//     RW * (threads / team) rows in flight: the TPU kernel's ring of DMA
//     semaphores. An index outside [0, rows) writes a row of zeros;
//   * with overlap, 8 more warps run chain.cuh's run_tile over the tile's
//     activation rows in 64-row sub-tiles (their own named barrier) while 4
//     gather warps keep their ring full.
// Bulk copies (cp.async.bulk with an mbarrier per slot) are later work.
//
// The plain torch version is fenerf_tpu_torch/ops/dma_gather.py::
// gather_reference (index_select).

#include "chain.cuh"

namespace {

using chain::bf16;

constexpr int TILE = 1024;          // indices per CTA
constexpr int GATHER_THREADS = 256;  // gather alone
constexpr int OVERLAP_GATHER = 128;  // gather threads beside 256 chain threads
constexpr int CHAIN_ROWS = 64;       // the overlapped chain's sub-tile

__host__ __device__ inline int team_size(int row_bytes, int nthreads) {
  int t = 1;
  while (t < row_bytes / 16 && t < nthreads) t <<= 1;
  return t;
}

// Rows [row0, row0 + TILE) of out by `nthreads` threads (gt in [0,
// nthreads)), RW rows in flight per thread stream; `bar` is their barrier.
template <int RW>
__device__ void gather_tile(const unsigned char* __restrict__ table,
                            long long n_rows, const int* __restrict__ idx,
                            int n, int row_bytes,
                            unsigned char* __restrict__ out, int row0,
                            int* s_idx, unsigned char* s_ring, int gt,
                            int nthreads, int bar) {
  const int valid = min(TILE, n - row0);
  for (int i = gt; i < valid; i += nthreads) s_idx[i] = idx[row0 + i];
  chain::group_sync(bar, nthreads);
  const int pieces = row_bytes / 16;
  const int team = team_size(row_bytes, nthreads);
  const int streams = nthreads / team;
  const int lane = gt % team, stream = gt / team;
  const int nr = valid > stream ? (valid - stream + streams - 1) / streams : 0;
  if (nr == 0) return;
  unsigned char* slots = s_ring + (size_t)stream * RW * row_bytes;
  for (int i = 0; i < nr + RW - 1; ++i) {
    if (i < nr) {
      const int src = s_idx[stream + i * streams];
      if (src >= 0 && src < n_rows) {
        unsigned char* slot = slots + (size_t)(i % RW) * row_bytes;
        const unsigned char* from = table + (size_t)src * row_bytes;
        for (int c = lane; c < pieces; c += team)
          chain::cp_async16(slot + c * 16, from + c * 16);
      }
    }
    chain::cp_async_commit();
    chain::cp_async_wait<RW - 1>();
    const int j = i - (RW - 1);  // the row whose copies have landed
    if (j >= 0) {
      const int r = stream + j * streams;
      const int src = s_idx[r];
      const bool ok = src >= 0 && src < n_rows;
      const unsigned char* slot = slots + (size_t)(j % RW) * row_bytes;
      unsigned char* to = out + (size_t)(row0 + r) * row_bytes;
      for (int c = lane; c < pieces; c += team) {
        const int4 v = ok ? *reinterpret_cast<const int4*>(slot + c * 16)
                          : make_int4(0, 0, 0, 0);
        *reinterpret_cast<int4*>(to + c * 16) = v;
      }
    }
  }
}

template <int RW>
__global__ void __launch_bounds__(GATHER_THREADS)
gather_kernel(const unsigned char* __restrict__ table, long long n_rows,
              const int* __restrict__ idx, int n, int row_bytes,
              unsigned char* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  gather_tile<RW>(table, n_rows, idx, n, row_bytes, out, blockIdx.x * TILE,
                  reinterpret_cast<int*>(smem), smem + TILE * 4, threadIdx.x,
                  GATHER_THREADS, 1);
}

template <int RW>
__global__ void __launch_bounds__(256 + OVERLAP_GATHER)
gather_overlap_kernel(const unsigned char* __restrict__ table,
                      long long n_rows, const int* __restrict__ idx, int n,
                      int row_bytes, unsigned char* __restrict__ out,
                      chain::Params P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const chain::Layout L = chain::group_layout(CHAIN_ROWS, P.h, 8);
  const int row0 = blockIdx.x * TILE;
  if (threadIdx.x < 256) {
    const int end = min(row0 + TILE, P.n);
    for (int r = row0; r < end; r += CHAIN_ROWS) {
      chain::run_tile<chain::EPI_NONE>(P, r, CHAIN_ROWS, smem, L,
                                       threadIdx.x, 8, 1);
      chain::group_sync(1, 256);  // the copy-out is done before the next x
    }
  } else {
    gather_tile<RW>(table, n_rows, idx, n, row_bytes, out, row0,
                    reinterpret_cast<int*>(smem + L.total),
                    smem + L.total + TILE * 4, threadIdx.x - 256,
                    OVERLAP_GATHER, 2);
  }
}

template <int RW>
int launch(const unsigned char* table, long long n_rows, const int* idx,
           int n, int row_bytes, unsigned char* out, const chain::Params* P,
           int smem, cudaStream_t stream) {
  const int blocks = (n + TILE - 1) / TILE;
  cudaError_t err;
  if (P == nullptr) {
    err = cudaFuncSetAttribute(gather_kernel<RW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    gather_kernel<RW><<<blocks, GATHER_THREADS, smem, stream>>>(
        table, n_rows, idx, n, row_bytes, out);
  } else {
    err = cudaFuncSetAttribute(gather_overlap_kernel<RW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    gather_overlap_kernel<RW><<<blocks, 256 + OVERLAP_GATHER, smem, stream>>>(
        table, n_rows, idx, n, row_bytes, out, *P);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows in flight per CTA for `ring`: ring / streams must be a power of two
// in [1, 64]; returns that quotient (RW), or 0 if `ring` is not covered.
// ops/dma_gather.py mirrors it.
int dma_gather_rw(int row_bytes, int ring, int overlap) {
  const int nthreads = overlap ? OVERLAP_GATHER : GATHER_THREADS;
  const int streams = nthreads / team_size(row_bytes, nthreads);
  if (ring % streams != 0) return 0;
  const int rw = ring / streams;
  return (rw >= 1 && rw <= 64 && (rw & (rw - 1)) == 0) ? rw : 0;
}

int dma_gather_smem(int row_bytes, int ring, int h, int overlap) {
  return TILE * 4 + ring * row_bytes +
         (overlap ? chain::group_layout(CHAIN_ROWS, h, 8).total : 0);
}

// out[i] = table[idx[i]] for n indices of rows of row_bytes bytes (a
// multiple of 16); with overlap, also act = the chain of x (n, h) bf16
// through w (layers, h, h) bf16. Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
int dma_gather_forward(const void* table, long long n_rows, const void* idx,
                       int n, int row_bytes, int ring, void* out,
                       const void* x, const void* w, int h, int layers,
                       void* act, int overlap, void* stream) {
  const int rw = dma_gather_rw(row_bytes, ring, overlap);
  const int smem = dma_gather_smem(row_bytes, ring, h, overlap);
  if (rw == 0 || row_bytes % 16 != 0 || smem > chain::MAX_SMEM ||
      (overlap && h % 64 != 0))
    return (int)cudaErrorInvalidValue;
  chain::Params P{(const bf16*)x, (const bf16*)w, nullptr, nullptr, nullptr,
                  (bf16*)act, n, h, layers};
  const chain::Params* pp = overlap ? &P : nullptr;
  const unsigned char* t = (const unsigned char*)table;
  const int* ix = (const int*)idx;
  unsigned char* o = (unsigned char*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (rw) {
    case 1: return launch<1>(t, n_rows, ix, n, row_bytes, o, pp, smem, s);
    case 2: return launch<2>(t, n_rows, ix, n, row_bytes, o, pp, smem, s);
    case 4: return launch<4>(t, n_rows, ix, n, row_bytes, o, pp, smem, s);
    case 8: return launch<8>(t, n_rows, ix, n, row_bytes, o, pp, smem, s);
    case 16: return launch<16>(t, n_rows, ix, n, row_bytes, o, pp, smem, s);
    case 32: return launch<32>(t, n_rows, ix, n, row_bytes, o, pp, smem, s);
    default: return launch<64>(t, n_rows, ix, n, row_bytes, o, pp, smem, s);
  }
}

const char* dma_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
