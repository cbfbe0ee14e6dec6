// Fused per-ray hierarchical-rendering kernels for NVIDIA Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of fenerf_tpu/ops/ray_finalize.py:
//   ray_resample  (ray_resample, pallas_call at ray_finalize.py:186): coarse
//                 sigma (+ pre-scaled noise) -> compositing weights ->
//                 interior proposal weights (w + 1e-5) + 1e-5 -> pdf, cdf ->
//                 inverse CDF at the given uniforms -> fine z;
//   ray_finalize  (ray_finalize, pallas_call at ray_finalize.py:376):
//                 stable depth ranks of [fine | coarse] -> delta by rank
//                 successor, noise by sorted position -> transmittance as
//                 exp of the exclusive prefix sum of log(1 - alpha + 1e-10)
//                 in depth order -> (comp, depth, weights_sum), the
//                 last/white/black background options and the fill +
//                 label-softmax epilogue.
//
// What bounds them on the card: bytes. ray_finalize reads each ray's
// (S_f + S_c) x (C + 1) f32 samples once (35 MB for a 4096-ray serving block
// of 96 samples x 22 channels) and does a few dozen operations per sample;
// ray_resample reads 3-4 S-vectors per ray and writes one (3 MB at the
// serving block, less than a launch's own cost at the memory rate). Both
// are far below the H100's operations-per-byte ridge.
//
// Arithmetic contract, shared with the plain torch versions in
// fenerf_tpu_torch/ops/ray_finalize.py (they repeat these additions
// exactly): every prefix sum runs in the TPU kernel's lane-doubling
// (Hillis-Steele) order x[i] += x[i - sh], sh = 1, 2, 4, ...; products that
// feed a sum are rounded on their own (__fmul_rn: no fused multiply-add);
// the proposal weights are (w + 1e-5) + 1e-5, their total the last element
// of the same doubling sum; a denominator below 1e-5 becomes 1; ranks are
// stable (ties go to the lower index, fine before coarse).
//
// Layout: one warp per ray. Sample i of a ray lives in lane i % 32, slot
// i / 32 of a register array (SL slots, S <= 32 SL; the kernels are
// templates on SL). A prefix-sum step with sh < 32 is one shuffle per slot
// and a select (the source of lane l < sh is the previous slot's lane
// l - sh + 32); a step with sh >= 32 shifts whole slots. So the sums run in
// registers with the plain versions' additions in the same order, without
// shared memory or __syncwarp. A row that every lane reads whole (z for the
// ranks, the weights for compositing) goes through a per-warp row of shared
// memory instead, read four floats at a time as a broadcast: cheaper than a
// shuffle per element.
//
// ray_resample: one round of global loads (z, sigma, noise, u at entry),
// the three prefix sums in registers, then cdf and bins in a small per-warp
// row of shared memory for the count of cdf_j < u (by bisection when the
// cdf is non-decreasing, as it nearly always is; else one by one) and the
// picks; one coalesced store of fine z. Four rays per CTA.
//
// ray_finalize: persistent CTAs of four warps; each warp walks rays
// gw, gw + G, ... (G warps in the grid) through a ring of RING ray stages in
// shared memory. A ray's fine block (S_f, C + 1) and coarse block (S_c,
// C + 1) are contiguous f32 runs: one elected lane moves each by one bulk
// copy (cp.async.bulk) into the stage, completing on the stage's mbarrier,
// RING rays ahead. While the copies stream in, the warp works on what needs
// only z (loaded into registers one ray ahead): stable ranks, the rank
// successor's z through a per-warp row of z in depth order, deltas, and the
// noise of each sample's sorted position (a shuffle from the noise row).
// The ranks count, for each sample, the z_j before it (-1 per set.le /
// set.lt, two IADD3 per four). When the coarse z are non-decreasing (the
// stratified z of the main path, checked by a vote) only the fine z_j are
// counted: a coarse sample is preceded by the coarse ones before it, and a
// fine one by the coarse z below its own, found by a branch-free bisection.
// That halves the count, the larger part of the kernel's instructions
// (scripts/profile_torch_ray_ablate.py). The warp waits on the barrier
// only before reading sigma. log(1 - alpha + 1e-10) goes to a per-warp row
// at its rank, is summed in registers in depth order and read back at each
// sample's rank. Compositing reads the stage: lane = channel, a sequential
// fused multiply-add over the samples, fine first. The stage is refilled
// with the ray RING ahead once its last reads are done. A block whose
// start or size is not a multiple of 16 bytes (S * (C + 1) not a multiple
// of 4, or a base pointer off 16) cannot be bulk-copied: then every lane
// moves it by 4-byte cp.async pieces completing on the same barrier
// (cp.async.mbarrier.arrive.noinc), so the ring and the rest of the kernel
// are the same. A ray's result depends on nothing but its own inputs, so
// it is bitwise the same wherever the ray lies in the launch.
//
// What holds it back (by removal, PERF.md): the latency of each warp's
// chain of dependent steps per ray, with 12 warps per SM; the two stages of
// 8.4 KB per warp at the serving block leave room for no more.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int WARPS = 4;              // warps per CTA, one ray at a time each
constexpr int THREADS = WARPS * 32;
constexpr int MAX_S = 256;            // samples per ray
constexpr int MAX_SL = MAX_S / 32;    // register slots per lane
constexpr int MAX_C = 128;            // output channels
constexpr int CSLOTS = MAX_C / 32;
constexpr int RING = 2;               // ray stages per warp (ray_finalize)
constexpr unsigned FULL = 0xffffffffu;

enum { FILL_NONE = 0, FILL_SEG_PAD = 1, FILL_WHITE = 2, FILL_DEBUG = 3 };

__device__ __forceinline__ float act_sigma(float x, int softplus) {
  // softplus as logaddexp(x, 0)
  return softplus ? fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))) : fmaxf(x, 0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

// In-place prefix sum of the n samples held as lane + 32 k -> x[k], in the
// TPU kernel's lane-doubling order: x[i] += x[i - sh] for sh = 1, 2, 4, ...
// (x[i] + 0 below sh, as the plain version pads); exclusive shifts by one
// more. Called by a whole warp; slots at or past n are left undefined.
template <int SL>
__device__ __forceinline__ void prefix_sum(float (&x)[SL], int n, int lane,
                                           bool exclusive) {
#pragma unroll
  for (int sh = 1; sh < 32; sh <<= 1) {
    if (sh >= n) break;
    const int src = (lane - sh) & 31;
    float a[SL];
#pragma unroll
    for (int k = 0; k < SL; ++k) a[k] = __shfl_sync(FULL, x[k], src);
    const bool same_slot = lane >= sh;
#pragma unroll
    for (int k = 0; k < SL; ++k)
      x[k] = x[k] + (same_slot ? a[k] : (k > 0 ? a[k > 0 ? k - 1 : 0] : 0.f));
  }
#pragma unroll
  for (int ks = 1; ks < SL; ks <<= 1) {
    if (32 * ks < n) {
      // descending, so each slot adds the one ks below before it changes
#pragma unroll
      for (int k = SL - 1; k >= 0; --k)
        x[k] = x[k] + (k >= ks ? x[k >= ks ? k - ks : 0] : 0.f);
    }
  }
  if (exclusive) {
    const int src = (lane - 1) & 31;
    float a[SL];
#pragma unroll
    for (int k = 0; k < SL; ++k) a[k] = __shfl_sync(FULL, x[k], src);
#pragma unroll
    for (int k = 0; k < SL; ++k)
      x[k] = lane >= 1 ? a[k] : (k > 0 ? a[k > 0 ? k - 1 : 0] : 0.f);
  }
}

// Element idx (per lane, in [0, 32 SL)) of a register row; every lane of
// the warp must call it.
template <int SL>
__device__ __forceinline__ float pick(const float (&x)[SL], int idx) {
  const int src = idx & 31, slot = idx >> 5;
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < SL; ++k) {
    const float t = __shfl_sync(FULL, x[k], src);
    if (slot == k) v = t;
  }
  return v;
}

// #{j < n : a[j] < x} for a non-decreasing row a in shared memory (n in
// [1, 256]; a NaN x counts none): the branch-free lower bound, whose
// halvings of n are the same for every lane
__device__ __forceinline__ int count_below(const float* a, int n, float x) {
  int base = 0;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    if (n <= 1) break;
    const int half = n >> 1;
    base = a[base + half] < x ? base + half : base;
    n -= half;
  }
  return base + (a[base] < x ? 1 : 0);
}

// ---------------------------------------------------------------------------
// ray_resample: one warp per ray, the sums in registers
// ---------------------------------------------------------------------------
template <int SL>
__global__ void __launch_bounds__(THREADS)
    ray_resample_kernel(const float* __restrict__ sigma,
                        const float* __restrict__ zv,
                        const float* __restrict__ noise,
                        const float* __restrict__ u, float* __restrict__ out,
                        int rows, int s, int n_imp, int softplus) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= rows) return;  // the whole warp leaves together
  const size_t base = (size_t)row * s, ubase = (size_t)row * n_imp;
  // the one round of loads
  float z[SL], sg[SL], nz[SL], uu[SL];
#pragma unroll
  for (int k = 0; k < SL; ++k) {
    const int i = lane + 32 * k;
    z[k] = i < s ? zv[base + i] : 0.f;
    sg[k] = i < s ? sigma[base + i] : 0.f;
    nz[k] = (noise != nullptr && i < s) ? noise[base + i] : 0.f;
    uu[k] = i < n_imp ? u[ubase + i] : 0.f;
  }
  // alphas, log(1 - alpha + 1e-10), the bins (midpoints)
  float al[SL], lo[SL], bins[SL];
#pragma unroll
  for (int k = 0; k < SL; ++k) {
    const int i = lane + 32 * k;
    const float down = __shfl_down_sync(FULL, z[k], 1);
    const float next_slot = __shfl_sync(FULL, z[k + 1 < SL ? k + 1 : k], 0);
    const float zn = lane < 31 ? down : (k + 1 < SL ? next_slot : 0.f);
    const float delta = i == s - 1 ? 1e10f : zn - z[k];
    float sgk = sg[k];
    if (noise != nullptr) sgk = sgk + nz[k];
    const float alpha = 1.f - expf(__fmul_rn(-delta, act_sigma(sgk, softplus)));
    al[k] = alpha;
    lo[k] = i < s ? logf(1.f - alpha + 1e-10f) : 0.f;
    bins[k] = 0.5f * (z[k] + zn);
  }
  prefix_sum<SL>(lo, s, lane, true);
  // interior proposal weights at positions 1..s-2 (pdf_j at j + 1)
  float wm[SL], cdf[SL];
#pragma unroll
  for (int k = 0; k < SL; ++k) {
    const int i = lane + 32 * k;
    wm[k] = (i >= 1 && i <= s - 2)
                ? (__fmul_rn(al[k], expf(lo[k])) + 1e-5f) + 1e-5f
                : 0.f;
    cdf[k] = wm[k];
  }
  // the total as the last element of the same doubling sum
  prefix_sum<SL>(cdf, s, lane, false);
  const float total = pick<SL>(cdf, s - 1);
#pragma unroll
  for (int k = 0; k < SL; ++k) cdf[k] = wm[k] / total;
  prefix_sum<SL>(cdf, s, lane, false);  // cdf_k for k < m
  const int m = s - 1;
  // cdf and bins into the warp's rows for the count and the picks
  __shared__ float rows_sm[WARPS][2][32 * SL];
  float* cdf_row = rows_sm[warp][0];
  float* bin_row = rows_sm[warp][1];
#pragma unroll
  for (int k = 0; k < SL; ++k) {
    cdf_row[lane + 32 * k] = cdf[k];
    bin_row[lane + 32 * k] = bins[k];
  }
  __syncwarp();
  // the doubling sums of non-negative terms are nearly always
  // non-decreasing; where they are (every j, checked by a vote), the count
  // of cdf_j < u is the lower bound of u, found by bisection
  bool ok = true;
#pragma unroll
  for (int k = 0; k < SL; ++k) {
    const int j = lane + 32 * k;
    const float down = __shfl_down_sync(FULL, cdf[k], 1);
    const float next_slot = __shfl_sync(FULL, cdf[k + 1 < SL ? k + 1 : k], 0);
    const float cn = lane < 31 ? down : next_slot;
    ok = ok && (j >= m - 1 || cdf[k] <= cn);
  }
  const bool sorted = __all_sync(FULL, ok);
  for (int q0 = 0; q0 < n_imp; q0 += 32 * SL) {
    if (q0 > 0) {
#pragma unroll
      for (int k = 0; k < SL; ++k) {
        const int q = q0 + lane + 32 * k;
        uu[k] = q < n_imp ? u[ubase + q] : 0.f;
      }
    }
    // inds = #{j < m : cdf_j < u}
    int cnt[SL];
    if (sorted) {
#pragma unroll
      for (int k = 0; k < SL; ++k) cnt[k] = count_below(cdf_row, m, uu[k]);
    } else {  // each cdf_j read from the row (a broadcast) and counted
#pragma unroll
      for (int k = 0; k < SL; ++k) cnt[k] = 0;
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        const float c = cdf_row[j];
#pragma unroll
        for (int k = 0; k < SL; ++k) cnt[k] += c < uu[k] ? 1 : 0;
      }
    }
#pragma unroll
    for (int k = 0; k < SL; ++k) {
      const int q = q0 + lane + 32 * k;
      const int below = min(max(cnt[k] - 1, 0), m - 1);
      const int above = min(max(cnt[k], 0), m - 1);
      const float cb = cdf_row[below], ca = cdf_row[above];
      const float bb = bin_row[below], ba = bin_row[above];
      float denom = ca - cb;
      if (denom < 1e-5f) denom = 1.f;
      if (q < n_imp) out[ubase + q] = bb + __fmul_rn((uu[k] - cb) / denom, ba - bb);
    }
  }
}

// -1 where a <= b (a < b), else 0; false for a NaN
__device__ __forceinline__ int le_mask(float a, float b) {
  int d;
  asm("set.le.s32.f32 %0, %1, %2;" : "=r"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ int lt_mask(float a, float b) {
  int d;
  asm("set.lt.s32.f32 %0, %1, %2;" : "=r"(d) : "f"(a), "f"(b));
  return d;
}

// Four samples j = 32 kk + jl0 + e (e < 4) of the z row against this lane's
// samples i = 32 k + lane: j precedes i if z_j < z_i, or z_j == z_i and
// j < i. neg[k] -= the count (set gives -1 for true; two IADD3 per four).
template <int SL>
__device__ __forceinline__ void rank_chunk(float4 q, int kk, int jl0,
                                           const float (&z)[SL], int lane,
                                           int (&neg)[SL]) {
  const float zj[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < SL; ++k) {
    int m[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kk < k)
        m[e] = le_mask(zj[e], z[k]);  // j < i
      else if (kk > k)
        m[e] = lt_mask(zj[e], z[k]);  // j > i
      else
        m[e] = jl0 + e < lane ? le_mask(zj[e], z[k]) : lt_mask(zj[e], z[k]);
    }
    neg[k] += (m[0] + m[1]) + (m[2] + m[3]);
  }
}

// ---------------------------------------------------------------------------
// ray_finalize: persistent warps, a ring of RING ray stages each
// ---------------------------------------------------------------------------
struct FinalizeArgs {
  const float* fo;     // (rows, sf, c1)
  const float* co;     // (rows, sc, c1)
  const float* fz;     // (rows, sf)
  const float* cz;     // (rows, sc)
  const float* noise;  // (rows, sf + sc) by sorted position, or null
  float* comp;         // (rows, c_out)
  float* depth;        // (rows,)
  float* wsum;         // (rows,)
  int rows, sf, sc, c1, softplus, last_back, white_back, black_back;
  int fill_mode;
  float fill_value;
  int softmax_label, rgb_dim, c_out;
  int bulk;          // blocks moved by bulk copies (16-byte aligned)
  int ring;          // ray stages per warp
  int stage_floats;  // floats per stage: (sf + sc) c1 rounded up to 4
};

// shared memory per warp: `ring` stages; three rows of t rounded up to 4:
// z in sample order (then the weights), z in depth order, log(1 - alpha +
// 1e-10) in depth order; the channel buffer (c rounded up to 4), in
// floats; then the barriers, 8 bytes per stage
__host__ __device__ inline int warp_floats(int ring, int stage_floats, int t,
                                           int c) {
  return ring * stage_floats + 3 * ((t + 3) & ~3) + ((c + 3) & ~3);
}

// a 4-byte piece global -> shared, tracked by this thread's cp.async groups
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}
// arrives on bar once every cp.async this thread issued before has landed
// (noinc: the arrival counts towards the barrier's expected count)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   hopper::smem_u32(bar))
               : "memory");
}

template <int SL>
__global__ void __launch_bounds__(THREADS)
    ray_finalize_kernel(const FinalizeArgs P) {
  extern __shared__ __align__(128) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int t = P.sf + P.sc, c = P.c1 - 1;
  const int fe = P.sf * P.c1, ce = P.sc * P.c1;  // floats per block
  const int wf = warp_floats(P.ring, P.stage_floats, t, c);
  float* stages = smem + (size_t)warp * wf;
  const int t4 = (t + 3) & ~3;
  float* zrow = stages + (size_t)P.ring * P.stage_floats;  // by sample
  float* zs = zrow + t4;       // z by rank
  float* scratch = zs + t4;    // log(1 - alpha + 1e-10) by rank
  float* cb = scratch + t4;    // by channel
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + (size_t)nwarps * wf) + warp * P.ring;
  if (lane == 0) {
    for (int s = 0; s < P.ring; ++s) hopper::mbar_init(&bars[s], P.bulk ? 1 : 32);
    hopper::fence_barrier_init();
  }
  __syncwarp();

  // the ray's blocks into stage s, completing on bars[s]
  auto issue = [&](int s, int row) {
    float* st = stages + (size_t)s * P.stage_floats;
    const float* f = P.fo + (size_t)row * fe;
    const float* co = P.co + (size_t)row * ce;
    if (P.bulk) {
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&bars[s], 4u * (fe + ce));
        hopper::bulk_copy_g2s(st, f, 4u * fe, &bars[s]);
        hopper::bulk_copy_g2s(st + fe, co, 4u * ce, &bars[s]);
      }
    } else {
      for (int i = lane; i < fe; i += 32) cp_async4(st + i, f + i);
      for (int i = lane; i < ce; i += 32) cp_async4(st + fe + i, co + i);
      cp_async_arrive(&bars[s]);
    }
  };
  // the ray's z and noise rows into registers
  auto load_z = [&](int row, float (&zr)[SL], float (&nr)[SL]) {
#pragma unroll
    for (int k = 0; k < SL; ++k) {
      const int i = lane + 32 * k;
      zr[k] = i < P.sf   ? P.fz[(size_t)row * P.sf + i]
              : i < t    ? P.cz[(size_t)row * P.sc + i - P.sf]
                         : 0.f;
      nr[k] = (P.noise != nullptr && i < t) ? P.noise[(size_t)row * t + i]
                                            : 0.f;
    }
  };

  const int G = gridDim.x * nwarps;
  const int first = blockIdx.x * nwarps + warp;
  for (int s = 0; s < P.ring; ++s)
    if (first + s * G < P.rows) issue(s, first + s * G);
  float zq[SL], nq[SL];  // the next ray's z and noise rows
  if (first < P.rows) load_z(first, zq, nq);

  for (int it = 0, row = first; row < P.rows; ++it, row += G) {
    const int s = it % P.ring;
    const uint32_t parity = (uint32_t)(it / P.ring) & 1u;
    float z[SL], nz[SL];
#pragma unroll
    for (int k = 0; k < SL; ++k) {
      z[k] = zq[k];
      nz[k] = nq[k];
    }
    if (row + G < P.rows) load_z(row + G, zq, nq);

    // stable ranks. When the coarse samples are non-decreasing (the
    // stratified z of the main path; checked with a vote), a coarse sample
    // is preceded by exactly the coarse samples before it and a fine one by
    // the coarse samples below its z, found by bisection; only the fine z_j
    // are then counted one by one. Otherwise every z_j is. They are read
    // four at a time from the z row (a broadcast).
#pragma unroll
    for (int k = 0; k < SL; ++k)
      if (lane + 32 * k < t) zrow[lane + 32 * k] = z[k];
    __syncwarp();
    bool up = true;
#pragma unroll
    for (int k = 0; k < SL; ++k) {
      const int i = lane + 32 * k;
      if (i >= P.sf && i + 1 < t) up = up && z[k] <= zrow[i + 1];
    }
    const bool coarse_up = __all_sync(FULL, up);
    const int jend = coarse_up ? P.sf : t;
    const float4* zr4 = reinterpret_cast<const float4*>(zrow);
    int rk[SL];
#pragma unroll
    for (int k = 0; k < SL; ++k) rk[k] = 0;
#pragma unroll
    for (int kk = 0; kk < SL; ++kk) {
      const int n = min(32, jend - 32 * kk);
      if (n == 32) {  // a whole slot: jl known at compile time
#pragma unroll
        for (int q = 0; q < 8; ++q)
          rank_chunk<SL>(zr4[8 * kk + q], kk, 4 * q, z, lane, rk);
      } else if (n > 0) {
        const int nq = n >> 2;
        for (int q = 0; q < nq; ++q)
          rank_chunk<SL>(zr4[8 * kk + q], kk, 4 * q, z, lane, rk);
        for (int j = 32 * kk + 4 * nq; j < 32 * kk + n; ++j) {
          const float zj = zrow[j];
#pragma unroll
          for (int k = 0; k < SL; ++k)
            rk[k] += j < lane + 32 * k ? le_mask(zj, z[k]) : lt_mask(zj, z[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < SL; ++k) rk[k] = -rk[k];
    if (coarse_up) {
#pragma unroll
      for (int k = 0; k < SL; ++k) {
        const int i = lane + 32 * k;
        if (32 * k < P.sf) {  // the slot holds fine samples
          const int below = count_below(zrow + P.sf, P.sc, z[k]);
          if (i < P.sf) rk[k] += below;
        }
        if (i >= P.sf) rk[k] += i - P.sf;
      }
    }
    // the rank successor's z, through the z row in depth order
#pragma unroll
    for (int k = 0; k < SL; ++k)
      if (lane + 32 * k < t) zs[rk[k]] = z[k];
    __syncwarp();
    float delta[SL], nr[SL];
#pragma unroll
    for (int k = 0; k < SL; ++k) {
      delta[k] = rk[k] >= t - 1 ? 1e10f : zs[rk[k] + 1] - z[k];
      nr[k] = 0.f;
    }
    if (P.noise != nullptr) {
#pragma unroll
      for (int k = 0; k < SL; ++k) nr[k] = pick<SL>(nz, rk[k]);
    }

    // sigma from the stage
    hopper::mbar_wait(&bars[s], parity);
    const float* st = stages + (size_t)s * P.stage_floats;
    float al[SL], w[SL];
#pragma unroll
    for (int k = 0; k < SL; ++k) {
      const int i = lane + 32 * k;
      al[k] = 0.f;
      if (i < t) {
        float sg = st[(size_t)i * P.c1 + c];
        if (P.noise != nullptr) sg = sg + nr[k];
        const float alpha =
            1.f - expf(__fmul_rn(-delta[k], act_sigma(sg, P.softplus)));
        al[k] = alpha;
        scratch[rk[k]] = logf(1.f - alpha + 1e-10f);
      }
    }
    __syncwarp();
    // transmittance: the exclusive sum in depth order, read back by rank
    float lo[SL];
#pragma unroll
    for (int k = 0; k < SL; ++k) {
      const int p = lane + 32 * k;
      lo[k] = p < t ? scratch[p] : 0.f;
    }
    prefix_sum<SL>(lo, t, lane, true);
#pragma unroll
    for (int k = 0; k < SL; ++k)
      if (lane + 32 * k < t) scratch[lane + 32 * k] = lo[k];
    __syncwarp();
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < SL; ++k) {
      w[k] = 0.f;
      if (lane + 32 * k < t) {
        w[k] = __fmul_rn(al[k], expf(scratch[rk[k]]));
        part += w[k];
      }
    }
    const float ws = warp_sum(part);
    if (P.last_back) {
#pragma unroll
      for (int k = 0; k < SL; ++k)
        if (lane + 32 * k < t && rk[k] == t - 1) w[k] = w[k] + (1.f - ws);
    }
    float dpart = 0.f;
#pragma unroll
    for (int k = 0; k < SL; ++k)
      if (lane + 32 * k < t) dpart += __fmul_rn(w[k], z[k]);
    const float d = warp_sum(dpart);

    // compositing: lane = channel, samples in order, fine first; the
    // weights read four at a time from the weight row (over the z row),
    // lanes past the channels read channel 0 and drop it
#pragma unroll
    for (int k = 0; k < SL; ++k)
      if (lane + 32 * k < t) zrow[lane + 32 * k] = w[k];
    __syncwarp();
    const float4* w4 = reinterpret_cast<const float4*>(zrow);
    for (int c0 = 0; c0 < c; c0 += 32) {
      const int ch = c0 + lane;
      const float* col = st + (ch < c ? ch : 0);
      float acc = 0.f;
      auto chunk = [&](int i0) {  // samples i0 .. i0 + 3
        const float4 wq = w4[i0 >> 2];
        const float* x = col + (size_t)i0 * P.c1;
        acc = fmaf(wq.x, x[0], acc);
        acc = fmaf(wq.y, x[P.c1], acc);
        acc = fmaf(wq.z, x[2 * P.c1], acc);
        acc = fmaf(wq.w, x[3 * P.c1], acc);
      };
#pragma unroll
      for (int kk = 0; kk < SL; ++kk) {
        if (32 * kk + 32 <= t) {
#pragma unroll
          for (int q = 0; q < 8; ++q) chunk(32 * kk + 4 * q);
        } else {
          const int n4 = (t - 32 * kk) >> 2;
          for (int q = 0; q < n4; ++q) chunk(32 * kk + 4 * q);
        }
      }
      for (int i = t & ~3; i < t; ++i)
        acc = fmaf(zrow[i], col[(size_t)i * P.c1], acc);
      if (P.white_back) acc = acc + (1.f - ws);
      if (P.black_back) acc = acc - (1.f - ws);
      if (ch < c) cb[ch] = acc;
    }
    // the stage's last reads are done: refill it with the ray RING ahead
    hopper::fence_proxy_async_smem();
    __syncwarp();
    if (row + P.ring * G < P.rows) issue(s, row + P.ring * G);

    // fill epilogue (integrate.apply_fill) per output channel
    const bool low = ws < 0.9f;
    float v[CSLOTS];
#pragma unroll
    for (int k = 0; k < CSLOTS; ++k) {
      const int oc = lane + 32 * k;
      float x = 0.f;
      if (oc < P.c_out) {
        if (P.fill_mode == FILL_SEG_PAD)
          x = oc == 0 ? (low ? 1.f : 0.f) : (low ? P.fill_value : cb[oc - 1]);
        else if (P.fill_mode == FILL_WHITE)
          x = low ? 1.f : cb[oc];
        else if (P.fill_mode == FILL_DEBUG)
          x = oc == 0 ? (low ? 1.f : cb[0]) : (low ? 0.f : cb[oc]);
        else
          x = cb[oc];
      }
      v[k] = x;
    }
    if (P.softmax_label) {  // softmax over the channels before the rgb ones
      const int n_seg = P.c_out - P.rgb_dim;
      float mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < CSLOTS; ++k)
        if (lane + 32 * k < n_seg) mx = fmaxf(mx, v[k]);
      mx = warp_max(mx);
      float se = 0.f;
#pragma unroll
      for (int k = 0; k < CSLOTS; ++k)
        if (lane + 32 * k < n_seg) {
          v[k] = expf(v[k] - mx);
          se += v[k];
        }
      se = warp_sum(se);
#pragma unroll
      for (int k = 0; k < CSLOTS; ++k)
        if (lane + 32 * k < n_seg) v[k] = v[k] / se;
    }
#pragma unroll
    for (int k = 0; k < CSLOTS; ++k) {
      const int oc = lane + 32 * k;
      if (oc < P.c_out) P.comp[(size_t)row * P.c_out + oc] = v[k];
    }
    if (lane == 0) {
      P.depth[row] = d;
      P.wsum[row] = ws;
    }
  }
}

// the floor of a launch, for the measurements beside the kernels
__global__ void empty_kernel() {}

// ---------------------------------------------------------------------------
// host side: per-device facts and per-instantiation settings, cached
// ---------------------------------------------------------------------------
constexpr int MAX_DEVICES = 16;

struct Device {
  int id = 0, sms = 0, smem_optin = 0;
};

int device_facts(Device* out) {
  static Device cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  Device& d = cache[dev];
  d.id = dev;
  if (d.sms == 0) {
    e = cudaDeviceGetAttribute(&d.smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      d.sms = 0;
      return (int)e;
    }
  }
  *out = d;
  return 0;
}

// CTAs of ray_finalize_kernel<SL> resident per SM of device `dev` at
// `smem` bytes (its dynamic shared-memory limit raised as needed), cached
// per device for the last (threads, smem)
template <int SL>
int finalize_occupancy(int dev, int threads, int smem, int* ctas) {
  struct Entry {
    int raised = 48 * 1024, smem = -1, threads = -1, ctas = 0;
  };
  static Entry cache[MAX_DEVICES];
  Entry& c = cache[dev];
  if (smem > c.raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        ray_finalize_kernel<SL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    c.raised = smem;
  }
  if (smem != c.smem || threads != c.threads) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &c.ctas, ray_finalize_kernel<SL>, threads, smem);
    if (e != cudaSuccess) return (int)e;
    c.smem = smem;
    c.threads = threads;
  }
  *ctas = c.ctas;
  return 0;
}

template <int SL>
int launch_finalize(const FinalizeArgs& a, const Device& dev, int warps,
                    int smem, cudaStream_t stream) {
  int ctas = 0;
  const int rc = finalize_occupancy<SL>(dev.id, 32 * warps, smem, &ctas);
  if (rc != 0) return rc;
  if (ctas < 1) return (int)cudaErrorInvalidConfiguration;
  const int need = (a.rows + warps - 1) / warps;
  const int blocks = need < dev.sms * ctas ? need : dev.sms * ctas;
  ray_finalize_kernel<SL><<<blocks, 32 * warps, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int SL>
void launch_resample(const float* sigma, const float* z, const float* noise,
                     const float* u, float* out, int rows, int s, int n_imp,
                     int softplus, cudaStream_t stream) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  ray_resample_kernel<SL><<<blocks, THREADS, 0, stream>>>(
      sigma, z, noise, u, out, rows, s, n_imp, softplus);
}

}  // namespace

extern "C" {

// Each launches its kernel on `stream` and returns cudaGetLastError()
// (0 = launched), or cudaErrorInvalidValue for shapes it does not cover.
int ray_resample_forward(const void* sigma, const void* z, const void* noise,
                         const void* u, void* out, int rows, int s, int n_imp,
                         int softplus, void* stream) {
  if (s < 3 || s > MAX_S || rows <= 0 || n_imp <= 0)
    return (int)cudaErrorInvalidValue;
  const float *sg = (const float*)sigma, *zz = (const float*)z,
              *nz = (const float*)noise, *uu = (const float*)u;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((s + 31) / 32) {
    case 1: launch_resample<1>(sg, zz, nz, uu, o, rows, s, n_imp, softplus, st); break;
    case 2: launch_resample<2>(sg, zz, nz, uu, o, rows, s, n_imp, softplus, st); break;
    case 3: launch_resample<3>(sg, zz, nz, uu, o, rows, s, n_imp, softplus, st); break;
    case 4: launch_resample<4>(sg, zz, nz, uu, o, rows, s, n_imp, softplus, st); break;
    case 5: launch_resample<5>(sg, zz, nz, uu, o, rows, s, n_imp, softplus, st); break;
    case 6: launch_resample<6>(sg, zz, nz, uu, o, rows, s, n_imp, softplus, st); break;
    case 7: launch_resample<7>(sg, zz, nz, uu, o, rows, s, n_imp, softplus, st); break;
    default: launch_resample<MAX_SL>(sg, zz, nz, uu, o, rows, s, n_imp, softplus, st);
  }
  return (int)cudaGetLastError();
}

int ray_finalize_forward(const void* fine_out, const void* coarse_out,
                         const void* fine_z, const void* coarse_z,
                         const void* noise, void* comp, void* depth,
                         void* wsum, int rows, int sf, int sc, int c1,
                         int softplus, int last_back, int white_back,
                         int black_back, int fill_mode, float fill_value,
                         int softmax_label, int rgb_dim, int c_out,
                         void* stream) {
  if (sf < 1 || sc < 1 || sf + sc > MAX_S || c1 < 2 || c_out < 1 ||
      c_out > MAX_C || c_out < c1 - 1 || rows <= 0 ||
      (softmax_label && (rgb_dim <= 0 || rgb_dim >= c_out)))
    return (int)cudaErrorInvalidValue;
  Device dev;
  const int rc = device_facts(&dev);
  if (rc != 0) return rc;
  const int t = sf + sc;
  FinalizeArgs a;
  a.fo = (const float*)fine_out;
  a.co = (const float*)coarse_out;
  a.fz = (const float*)fine_z;
  a.cz = (const float*)coarse_z;
  a.noise = (const float*)noise;
  a.comp = (float*)comp;
  a.depth = (float*)depth;
  a.wsum = (float*)wsum;
  a.rows = rows;
  a.sf = sf;
  a.sc = sc;
  a.c1 = c1;
  a.softplus = softplus;
  a.last_back = last_back;
  a.white_back = white_back;
  a.black_back = black_back;
  a.fill_mode = fill_mode;
  a.fill_value = fill_value;
  a.softmax_label = softmax_label;
  a.rgb_dim = rgb_dim;
  a.c_out = c_out;
  a.bulk = ((uintptr_t)fine_out % 16 == 0 && (uintptr_t)coarse_out % 16 == 0 &&
            (sf * c1) % 4 == 0 && (sc * c1) % 4 == 0);
  a.stage_floats = (t * c1 + 3) & ~3;
  // WARPS warps of RING stages; halve the warps, then drop to one stage,
  // where a ray's blocks are too large for that (at most 132 KB a stage)
  int warps = WARPS, ring = RING;
  auto smem = [&]() {
    return (size_t)warps * (4 * warp_floats(ring, a.stage_floats, t, c1 - 1) +
                            8 * ring);
  };
  while (smem() > (size_t)dev.smem_optin) {
    if (warps > 1)
      warps >>= 1;
    else if (ring > 1)
      ring = 1;
    else
      return (int)cudaErrorInvalidValue;
  }
  a.ring = ring;
  const int bytes = (int)smem();
  cudaStream_t st = (cudaStream_t)stream;
  switch ((t + 31) / 32) {
    case 1: return launch_finalize<1>(a, dev, warps, bytes, st);
    case 2: return launch_finalize<2>(a, dev, warps, bytes, st);
    case 3: return launch_finalize<3>(a, dev, warps, bytes, st);
    case 4: return launch_finalize<4>(a, dev, warps, bytes, st);
    case 5: return launch_finalize<5>(a, dev, warps, bytes, st);
    case 6: return launch_finalize<6>(a, dev, warps, bytes, st);
    case 7: return launch_finalize<7>(a, dev, warps, bytes, st);
    default: return launch_finalize<MAX_SL>(a, dev, warps, bytes, st);
  }
}

// an empty kernel over `blocks` CTAs of `threads`: the floor the ray
// kernels' times are read against (scripts/profile_torch_ray_kernels.py)
int ray_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* ray_finalize_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
