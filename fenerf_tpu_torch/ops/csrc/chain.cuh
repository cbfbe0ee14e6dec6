// One warp group's row tile through an L-layer bf16 chain on nvcuda::wmma,
// for NVIDIA Hopper (sm_90a). Included by dma_gather.cu (the gather
// overlapped with the chain) alone; run_chain and run_epi run on wgmma in
// mxu_chain.cu, run_wide in mxu_wide.cu.
//
// Layer i:  a <- bf16(a @ W[i])  with bf16 operands, f32 accumulation and
// round-to-nearest-even output.
//
// Design (simple and right first):
//   * a group of `warps` warps owns `rows` (a multiple of 32) rows; its
//     warps form a grid of 32 x 64 warp tiles, rows / 32 high and
//     warps / (rows / 32) wide, so one pass computes nc = 64 * that width
//     output columns and a layer takes ceil(h / nc) passes;
//   * activations live in shared memory as bf16, in two buffers (a layer
//     reads one and writes the other; a multi-pass layer cannot work in
//     place). Storing them rounded is exact: every consumer is a bf16
//     product;
//   * weights do not fit (128 KB per layer at width 256, 512 KB at 512):
//     they stream through a two-buffer ring of 32-row chunks with cp.async,
//     the next chunk (across pass and layer boundaries) in flight while the
//     current one feeds the tensor cores;
//   * nvcuda::wmma bf16 16x16x16 fragments, f32 accumulators (2 x 4 per
//     warp); the rounding goes through a 1 KB per-warp f32 tile, each lane
//     finishing 8 consecutive columns of one row with 16-byte accesses;
//   * a group synchronises with its own named barrier, so several groups
//     in one CTA run their chains independently.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>

namespace chain {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int KC = 32;               // weight rows per staged chunk
constexpr int WM = 32, WN = 64;      // warp tile
constexpr int FM = WM / 16, FN = WN / 16;
constexpr int MAX_SMEM = 232448;     // a CTA's dynamic shared memory on H100

struct Params {
  const bf16* x;    // (n, h)
  const bf16* w;    // (layers, h, h): layer i computes a @ w[i]
  bf16* out;        // (n, h)
  int n, h, layers;
};

__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

// Shared-memory map of one group; row pitches carry 8 extra bf16 so that
// the eight 16-byte rows one fragment load touches fall in distinct banks.
struct Layout {
  int nc, pitch, wpitch, off_a, off_b, off_w0, off_w1, off_scr, total;
};

__host__ __device__ inline Layout group_layout(int rows, int h, int warps) {
  Layout L;
  L.nc = warps / (rows / WM) * WN;
  L.pitch = h + 8;
  L.wpitch = L.nc + 8;
  int off = 0;
  L.off_a = off;
  off = align128(off + rows * L.pitch * 2);
  L.off_b = off;
  off = align128(off + rows * L.pitch * 2);
  L.off_w0 = off;
  off = align128(off + KC * L.wpitch * 2);
  L.off_w1 = off;
  off = align128(off + KC * L.wpitch * 2);
  L.off_scr = off;
  off = align128(off + warps * 256 * 4);
  L.total = off;
  return L;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a barrier over the nthreads threads of one group (id 1..15)
__device__ __forceinline__ void group_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

// Rows [row0, row0 + rows) of P.x through the chain into P.out (rows past
// P.n are computed on zeros and not written). `gt` is the thread's index in
// its group of `warps` warps, `bar` the group's barrier id, `smem` the
// group's Layout-sized region.
__device__ void run_tile(const Params& P, int row0, int rows,
                         unsigned char* smem, const Layout& L, int gt,
                         int warps, int bar) {
  const int nthreads = warps * 32;
  const int warp = gt >> 5, lane = gt & 31;
  const int h = P.h;
  bf16* buf[2] = {reinterpret_cast<bf16*>(smem + L.off_a),
                  reinterpret_cast<bf16*>(smem + L.off_b)};
  bf16* wbuf[2] = {reinterpret_cast<bf16*>(smem + L.off_w0),
                   reinterpret_cast<bf16*>(smem + L.off_w1)};
  float* scr = reinterpret_cast<float*>(smem + L.off_scr) + warp * 256;
  const int col_warps = L.nc / WN;
  const int wr = warp / col_warps, wc = warp - wr * col_warps;
  const int valid = min(rows, P.n - row0);
  const int vpr = h / 8;  // 16-byte vectors per activation row

  // the x tile into buf[0]; rows past the end are zeros
  for (int v = gt; v < rows * vpr; v += nthreads) {
    const int r = v / vpr, c = (v - r * vpr) * 8;
    bf16* dst = buf[0] + r * L.pitch + c;
    if (r < valid) {
      cp_async16(dst, P.x + (size_t)(row0 + r) * h + c);
    } else {
      *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
    }
  }
  cp_async_commit();

  const int passes = (h + L.nc - 1) / L.nc;
  const int chunks = h / KC;            // per pass
  const int per_layer = passes * chunks;
  const int total = P.layers * per_layer;
  // chunk g of the flat (layer, pass, k-chunk) sequence into wbuf[g & 1]
  auto stage = [&](int g) {
    const int l = g / per_layer, rem = g - l * per_layer;
    const int pass = rem / chunks, c = rem - pass * chunks;
    const int n0 = pass * L.nc;
    const int vr = min(L.nc, h - n0) / 8;
    const bf16* src = P.w + (size_t)l * h * h + (size_t)c * KC * h + n0;
    bf16* dst = wbuf[g & 1];
    for (int v = gt; v < KC * vr; v += nthreads) {
      const int r = v / vr, cv = v - r * vr;
      cp_async16(dst + r * L.wpitch + cv * 8, src + (size_t)r * h + cv * 8);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
  stage(0);
  int g = 0;
  for (int l = 0; l < P.layers; ++l) {
    const bf16* src = buf[l & 1];
    bf16* dst = buf[(l + 1) & 1];
    for (int pass = 0; pass < passes; ++pass) {
      const int n0 = pass * L.nc;
      const bool active = n0 + wc * WN < h;
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
      for (int c = 0; c < chunks; ++c, ++g) {
        if (g + 1 < total) {
          stage(g + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        group_sync(bar, nthreads);  // chunk g (and the x tile) have landed
        if (active) {
          const bf16* wb = wbuf[g & 1];
#pragma unroll
          for (int kk = 0; kk < KC; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
#pragma unroll
            for (int i = 0; i < FM; ++i)
              wmma::load_matrix_sync(
                  a[i], src + (wr * WM + i * 16) * L.pitch + c * KC + kk,
                  L.pitch);
#pragma unroll
            for (int j = 0; j < FN; ++j) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
              wmma::load_matrix_sync(bm, wb + kk * L.wpitch + wc * WN + j * 16,
                                     L.wpitch);
#pragma unroll
              for (int i = 0; i < FM; ++i)
                wmma::mma_sync(acc[i][j], a[i], bm, acc[i][j]);
            }
          }
        }
        group_sync(bar, nthreads);  // wbuf[g & 1] is free for chunk g + 2
      }
      if (!active) continue;
      // rounding of this pass: columns [n0 + wc * WN, + WN) of dst. Other
      // warps read only src until the next layer, which starts after a
      // group barrier.
      const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
      for (int i = 0; i < FM; ++i) {
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
          __syncwarp();
          const int col = n0 + wc * WN + j * 16 + ec;
          const int row = wr * WM + i * 16 + er;
          const float4* sv = reinterpret_cast<const float4*>(scr + er * 16 + ec);
          const float4 s0 = sv[0], s1 = sv[1];
          const float v[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
          __align__(16) bf16 packed[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) packed[e] = __float2bfloat16_rn(v[e]);
          *reinterpret_cast<int4*>(dst + row * L.pitch + col) =
              *reinterpret_cast<const int4*>(packed);
          __syncwarp();
        }
      }
    }
  }
  group_sync(bar, nthreads);  // the last layer's output is complete
  const bf16* fin = buf[P.layers & 1];
  for (int v = gt; v < valid * vpr; v += nthreads) {
    const int r = v / vpr, c = (v - r * vpr) * 8;
    *reinterpret_cast<int4*>(P.out + (size_t)(row0 + r) * h + c) =
        *reinterpret_cast<const int4*>(fin + r * L.pitch + c);
  }
}

}  // namespace chain
