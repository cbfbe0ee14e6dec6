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
// Design: the copy engine moves every byte, the threads only issue.
//   * a CTA owns 1024 indices and loads them into shared memory itself
//     (the card has no scalar prefetch);
//   * the ring is `ring` row slots in shared memory, each with a full
//     mbarrier: the TPU kernel's ring of DMA semaphores. A row comes in by
//     one bulk copy (cp.async.bulk, completing on its slot's barrier with
//     the row's byte count) and goes out by one bulk copy from the slot
//     (cp.async.bulk ... bulk_group), so no byte passes through registers;
//   * one elected lane per issuing warp owns a contiguous share of the
//     slots and every warps-th row of the tile. It loads row t and stores
//     row t - (R - 1) of its own stream (R slots): the store of a slot's
//     previous row was issued an iteration earlier, and
//     cp.async.bulk.wait_group.read 1 shows that it has read the slot
//     before the slot is refilled. No other thread takes part, so no
//     empty barriers are needed;
//   * a warp issues its bulk copies one after another, a few hundred ns a
//     row (scripts/profile_torch_gather_variants.py: one warp per CTA
//     gathers 512 B rows at a third of the memory rate), so GATHER_WARPS
//     warps share the ring; past 8 the memory system, not the issue, is
//     the limit;
//   * an index outside [0, rows) loads nothing: the lane zeroes the slot
//     with ordinary stores, fences them for the async proxy and arrives on
//     the barrier without bytes, so the phases stay in step and the row of
//     zeros leaves by the same bulk store;
//   * with overlap, 8 warps run chain.cuh's run_tile over the tile's
//     activation rows in 64-row sub-tiles (their own named barrier) while
//     one more warp runs the same ring.
//
// The plain torch version is fenerf_tpu_torch/ops/dma_gather.py::
// gather_reference (index_select).

#include "chain.cuh"
#include "hopper.cuh"

namespace {

using chain::bf16;

constexpr int TILE = 1024;          // indices per CTA
constexpr int GATHER_WARPS = 8;     // issuing warps of the gather alone
constexpr int CHAIN_THREADS = 256;  // the overlapped chain's 8 warps
constexpr int CHAIN_ROWS = 64;      // the overlapped chain's sub-tile

// the gather's shared memory: the tile's indices, the ring's slots, one
// full barrier per slot
__host__ __device__ inline int ring_smem(int row_bytes, int ring) {
  return TILE * 4 + ring * (row_bytes + 8);
}

// One issuing lane's share of the ring.
struct Ring {
  unsigned char* slots;  // R slots of row_bytes
  uint64_t* full;        // one barrier per slot
  int shift;             // R = 1 << shift
};

// Rows first, first + step, ... below `valid` of the tile at s_idx /
// out_tile, through the lane's ring.
__device__ void gather_rows(const unsigned char* __restrict__ table,
                            long long n_rows, const int* s_idx, int first,
                            int step, int valid, int row_bytes,
                            unsigned char* __restrict__ out_tile,
                            const Ring& rg) {
  const int nr = valid > first ? (valid - first + step - 1) / step : 0;
  if (nr == 0) return;
  const int R = 1 << rg.shift;
  const int lag = min(R - 1, nr - 1);
  auto slot = [&](int k) {
    return rg.slots + (size_t)(k & (R - 1)) * row_bytes;
  };
  auto store = [&](int k) {
    hopper::mbar_wait(&rg.full[k & (R - 1)], (k >> rg.shift) & 1);
    hopper::bulk_copy_s2g(out_tile + (size_t)(first + k * step) * row_bytes,
                          slot(k), row_bytes);
    hopper::bulk_commit();
  };
  for (int t = 0; t < nr + lag; ++t) {
    if (lag > 0 && t >= lag) store(t - lag);
    if (t < nr) {
      // the slot's previous row (t - R) was stored before the newest
      // group; with lag 0 it is the newest
      if (lag > 0)
        hopper::bulk_wait_read<1>();
      else
        hopper::bulk_wait_read<0>();
      uint64_t* bar = &rg.full[t & (R - 1)];
      const int src = s_idx[first + t * step];
      if (src >= 0 && src < n_rows) {
        hopper::mbar_arrive_expect_tx(bar, row_bytes);
        hopper::bulk_copy_g2s(slot(t), table + (size_t)src * row_bytes,
                              row_bytes, bar);
      } else {
        int4* z = reinterpret_cast<int4*>(slot(t));
        for (int c = 0; c < row_bytes / 16; ++c)
          z[c] = make_int4(0, 0, 0, 0);
        hopper::fence_proxy_async_smem();
        hopper::mbar_arrive(bar);
      }
    }
    if (lag == 0) store(t);
  }
  hopper::bulk_wait_all();  // the slots stay valid until the rows are out
}

// The tile's indices into s_idx and the ring's barriers initialised, by
// threads [0, nthreads) (the caller synchronises them afterwards).
__device__ void tile_setup(const int* __restrict__ idx, int row0, int valid,
                           int* s_idx, uint64_t* full, int ring, int t,
                           int nthreads) {
  for (int i = t; i < ring; i += nthreads) hopper::mbar_init(&full[i], 1);
  hopper::fence_barrier_init();
  for (int i = t; i < valid; i += nthreads) s_idx[i] = idx[row0 + i];
}

__global__ void __launch_bounds__(32 * GATHER_WARPS)
gather_kernel(const unsigned char* __restrict__ table, long long n_rows,
              const int* __restrict__ idx, int n, int row_bytes, int ring,
              unsigned char* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* s_idx = reinterpret_cast<int*>(smem);
  unsigned char* slots = smem + TILE * 4;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(slots + (size_t)ring * row_bytes);
  const int row0 = blockIdx.x * TILE;
  const int valid = min(TILE, n - row0);
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  tile_setup(idx, row0, valid, s_idx, full, ring, threadIdx.x, blockDim.x);
  __syncthreads();
  if (threadIdx.x % 32 != 0) return;
  const int shift = __ffs(ring / warps) - 1;
  const Ring rg{slots + ((size_t)warp << shift) * row_bytes,
                full + (warp << shift), shift};
  gather_rows(table, n_rows, s_idx, warp, warps, valid, row_bytes,
              out + (size_t)row0 * row_bytes, rg);
}

__global__ void __launch_bounds__(CHAIN_THREADS + 32)
gather_overlap_kernel(const unsigned char* __restrict__ table,
                      long long n_rows, const int* __restrict__ idx, int n,
                      int row_bytes, int ring, unsigned char* __restrict__ out,
                      chain::Params P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const chain::Layout L = chain::group_layout(CHAIN_ROWS, P.h, 8);
  const int row0 = blockIdx.x * TILE;
  if (threadIdx.x < CHAIN_THREADS) {
    const int end = min(row0 + TILE, P.n);
    for (int r = row0; r < end; r += CHAIN_ROWS) {
      chain::run_tile(P, r, CHAIN_ROWS, smem, L, threadIdx.x, 8, 1);
      // the copy-out is done before the next x
      chain::group_sync(1, CHAIN_THREADS);
    }
    return;
  }
  // the gather warp
  int* s_idx = reinterpret_cast<int*>(smem + L.total);
  unsigned char* slots = smem + L.total + TILE * 4;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(slots + (size_t)ring * row_bytes);
  const int lane = threadIdx.x - CHAIN_THREADS;
  const int valid = min(TILE, n - row0);
  tile_setup(idx, row0, valid, s_idx, full, ring, lane, 32);
  __syncwarp();
  if (lane != 0) return;
  const Ring rg{slots, full, __ffs(ring) - 1};
  gather_rows(table, n_rows, s_idx, 0, 1, valid, row_bytes,
              out + (size_t)row0 * row_bytes, rg);
}

}  // namespace

extern "C" {

// Rows in flight per issuing lane for `ring` (the powers of two), or 0 if
// `ring` is not covered. ops/dma_gather.py mirrors it.
int dma_gather_rw(int row_bytes, int ring, int overlap) {
  if (ring < 1 || (ring & (ring - 1)) != 0 || row_bytes < 16) return 0;
  return overlap ? ring : ring / min(ring, GATHER_WARPS);
}

int dma_gather_smem(int row_bytes, int ring, int h, int overlap) {
  return ring_smem(row_bytes, ring) +
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
  const int smem = dma_gather_smem(row_bytes, ring, h, overlap);
  if (dma_gather_rw(row_bytes, ring, overlap) == 0 || row_bytes % 16 != 0 ||
      smem > chain::MAX_SMEM || (overlap && h % 64 != 0))
    return (int)cudaErrorInvalidValue;
  const unsigned char* t = (const unsigned char*)table;
  const int* ix = (const int*)idx;
  unsigned char* o = (unsigned char*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (n + TILE - 1) / TILE;
  cudaError_t err;
  if (!overlap) {
    err = cudaFuncSetAttribute(
        gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    gather_kernel<<<blocks, 32 * min(ring, GATHER_WARPS), smem, s>>>(
        t, n_rows, ix, n, row_bytes, ring, o);
  } else {
    chain::Params P{(const bf16*)x, (const bf16*)w, (bf16*)act, n, h,
                    layers};
    err = cudaFuncSetAttribute(gather_overlap_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    gather_overlap_kernel<<<blocks, CHAIN_THREADS + 32, smem, s>>>(
        t, n_rows, ix, n, row_bytes, ring, o, P);
  }
  return (int)cudaGetLastError();
}

const char* dma_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
