// The field's ceiling probes for NVIDIA Hopper (sm_90a): a pure bf16 chain
// of products, and the same chain with the FiLM / sine epilogue.
//
// Replaces the Pallas TPU kernels scripts/profile_mxu_chain.py::run_chain
// (pallas_call at :73) and scripts/profile_epilogue_overlap.py::run_epi
// (:88). Layer i computes, with bf16 operands, f32 accumulation and the
// output rounded to bf16 (round to nearest even):
//   EPI_NONE  a <- bf16(a @ W[i])                               (run_chain)
//   EPI_FILM  a <- bf16(fast_sin(f[i] * (a @ W[i] + b[i]) + p[i]))  (run_epi)
//   EPI_FOLD  a <- bf16(fast_sin(a @ bf16(W[i] * bf16(f[i])) + q[i])),
//             q[i] = f[i] * b[i] + p[i]                  (run_epi, fold)
// They measure what bounds the fused field kernel (film_mlp.cu, the same
// 11-layer 256-wide FiLM-sine chain): its products alone, or the products
// plus the f32 epilogue on the CUDA cores. run_wide (width 512) is in
// mxu_wide.cu.
//
// What bounds them on the card: operations. 2 * n * h^2 * layers FLOPs
// against 2 * n * h * 2 bytes of activations in and out; at n = 2^20,
// h = 256, 11 layers that is 1.51 TFLOP against 1.07 GB, far above the
// H100's ~295 FLOP/byte ridge. The epilogue adds ~12 f32 instructions per
// output element on the CUDA cores, which hide under the products or add
// to them: that is what run_epi measures.
//
// Design (film_mlp.cu's, without heads, batch elements or label branch; the
// building blocks are in hopper.cuh):
//   * one persistent CTA per SM: a producer warpgroup, in which one elected
//     lane issues bulk copies onto mbarriers, and two consumer warpgroups of
//     64 rows each;
//   * weights: chain_pack.cuh's pack_kernel (launched by the same entry
//     point, in the same stream) writes (layers, h, h) into 128-column
//     passes of 64-row K chunks, each in wgmma's 128-byte-swizzled K-major
//     B layout and contiguous, so one bulk copy moves one chunk onto a ring
//     of up to eight 16 KB stages. Widths under 256 are padded to 128 or
//     256 output columns with zero weights. For the folded epilogue the
//     pack also forms bf16(W * bf16(f)) and q = f * b + p;
//   * products: wgmma m64n128k16 with A from registers. A layer of 256
//     columns runs as two passes of 128 over the whole K; each pass's
//     accumulator goes through the epilogue and becomes the next layer's A
//     fragments in registers (hopper::acc_to_afrag), so activations never
//     return to shared memory between layers. The x tile comes in by one
//     bulk copy per consumer, prefetched a tile ahead; the last layer is
//     stored from registers;
//   * the epilogue's b, f, p (or q) of every layer are staged in shared
//     memory once per CTA; the epilogue has no per-element branch (rows
//     past n compute on whatever the x buffer holds and are not stored);
//   * tile / interleave: (64, 1) each consumer walks its own 64-row tiles
//     on its own half of the ring; (128, 1) both consumers take the two
//     halves of a 128-row tile and every weight stage feeds both, halving
//     the L2 weight stream; (128, 2) the same, the consumers offset by one
//     pass (half a layer at width 256) through two named barriers: each
//     issues a pass and hands the tensor cores to the other, whose
//     products then run under its epilogue (the card's reading of the TPU
//     kernel's k-way row interleave, FlashAttention-3's ping-pong). No
//     variant changes a row's arithmetic: every variant gives the same
//     bits;
//   * registers: setmaxnreg gives the consumers 240 (a 64 x 128 f32
//     accumulator, the layer's A fragments and the first pass's output
//     fragments, 64 each) and the producer 24.
//
// The plain torch versions are fenerf_tpu_torch/ops/mxu_chain.py::
// chain_reference and epi_reference; pack_chain_weights writes the same
// bytes as pack_kernel.

#include "chain_pack.cuh"
#include "hopper.cuh"

#include <stddef.h>
#include <stdint.h>

using namespace hopper;
typedef __nv_bfloat16 bf16;

namespace {

using chain_pack::KCHUNK;   // K rows per weight chunk
using chain_pack::PASS;     // output columns per pass
using chain_pack::pack_kernel;

constexpr int THREADS = 384;         // 2 consumer warpgroups + the producer
constexpr int WG_ROWS = 64;          // rows per consumer warpgroup
constexpr int STAGE_BYTES = PASS * KCHUNK * 2;
constexpr int MAX_STAGES = 8;
constexpr int MAX_SMEM = 232448 - 1024;   // less the alignment slack
// weight stages a launch needs: in MODE_ILV2 a consumer may take the next
// pass's chunks (4 at width 256) while the other still holds one of the
// last pass's
constexpr int MIN_STAGES = 6;

enum { EPI_NONE = 0, EPI_FILM = 1, EPI_FOLD = 2 };
// T64: each consumer its own 64-row tiles and ring; T128: both on one
// 128-row tile and one ring; ILV2: T128 with the consumers one pass apart
enum { MODE_T64 = 0, MODE_T128 = 1, MODE_ILV2 = 2 };

// chain_pack::padded(h) at the widths this kernel covers (up to 256): one
// or two passes, which the compiler then knows
__host__ __device__ inline int padded(int h) { return h <= PASS ? PASS : 2 * PASS; }
__host__ __device__ inline int n_vec(int epi) {
  return epi == EPI_FILM ? 3 : epi == EPI_FOLD ? 1 : 0;
}

struct Layout {
  int stages, off_w, off_x, off_epi, total;
};

// [mbarriers | weight stages (1024-aligned) | the two consumers' x tiles |
//  the epilogue vectors of every layer, zero past h]
__host__ __device__ inline Layout make_layout(int h, int layers, int epi) {
  Layout L;
  const int x_bytes = 2 * WG_ROWS * h * 2;
  const int epi_bytes = (n_vec(epi) * layers * padded(h) * 4 + 127) / 128 * 128;
  L.off_w = 1024;
  const int st = (MAX_SMEM - 1024 - x_bytes - epi_bytes) / STAGE_BYTES;
  L.stages = st < MAX_STAGES ? st : MAX_STAGES;
  L.off_x = L.off_w + L.stages * STAGE_BYTES;
  L.off_epi = L.off_x + x_bytes;
  L.total = L.off_epi + epi_bytes;
  return L;
}

struct Pipe {
  int s;         // stage of the next chunk
  uint32_t ph;   // its phase parity
  int prev;      // stage whose products may still be in flight, or -1
};

struct Consumer {
  uint64_t* full;
  uint64_t* empty;
  uint32_t stage0;   // shared address of the ring's first stage
  int stages;
  int lane, t;

  // one K block of a pass: the chunk's stage is waited for at its first
  // block; at its last, the previous chunk's products are waited for and
  // its stage released (one chunk of products stays in flight)
  __device__ __forceinline__ void mma(float* acc, const uint32_t* a, int kb,
                                      int nkb, Pipe& p) const {
    const int kp = kb & 3;
    if (kp == 0) mbar_wait(&full[p.s], p.ph);
    const uint32_t addr = stage0 + p.s * STAGE_BYTES + kp * 32;
    wgmma_fence();
    Wgmma<PASS>::template rs<0>(acc, a, desc_sw128(addr, 16, 1024), kb);
    if (kp == 3 || kb == nkb - 1) {
      wgmma_commit();
      if (p.prev >= 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[p.prev]);
      }
      p.prev = p.s;
      if (++p.s == stages) {
        p.s = 0;
        p.ph ^= 1;
      }
    }
  }
};

// columns c0 .. c0 + PASS of a layer: the epilogue in place, then the bf16
// A fragments of the next layer into `fo`
template <int EPI>
__device__ __forceinline__ void epilogue(float* acc, uint32_t* fo,
                                         const float* v0, const float* v1,
                                         const float* v2, int c0, int t) {
#pragma unroll
  for (int j = 0; j < PASS / 8; ++j) {
    const int c = c0 + 8 * j + 2 * t;
    if (EPI == EPI_FILM) {
      const float2 b = *reinterpret_cast<const float2*>(v0 + c);
      const float2 f = *reinterpret_cast<const float2*>(v1 + c);
      const float2 p = *reinterpret_cast<const float2*>(v2 + c);
      acc[4 * j] = fast_sin(f.x * (acc[4 * j] + b.x) + p.x);
      acc[4 * j + 1] = fast_sin(f.y * (acc[4 * j + 1] + b.y) + p.y);
      acc[4 * j + 2] = fast_sin(f.x * (acc[4 * j + 2] + b.x) + p.x);
      acc[4 * j + 3] = fast_sin(f.y * (acc[4 * j + 3] + b.y) + p.y);
    } else if (EPI == EPI_FOLD) {
      const float2 q = *reinterpret_cast<const float2*>(v0 + c);
      acc[4 * j] = fast_sin(acc[4 * j] + q.x);
      acc[4 * j + 1] = fast_sin(acc[4 * j + 1] + q.y);
      acc[4 * j + 2] = fast_sin(acc[4 * j + 2] + q.x);
      acc[4 * j + 3] = fast_sin(acc[4 * j + 3] + q.y);
    }
  }
  acc_to_afrag<PASS>(acc, fo);
}

template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
chain_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wdev,
             const float* __restrict__ e0, const float* __restrict__ e1,
             const float* __restrict__ e2, bf16* __restrict__ out, int n,
             int h, int layers, int mode) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled stages need 1024-byte alignment (the launch adds the slack)
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Layout L = make_layout(h, layers, EPI);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* xfull = empty + MAX_STAGES;
  uint64_t* xempty = xfull + 2;
  const int tid = threadIdx.x;
  const int rings = mode == MODE_T64 ? 2 : 1;
  const int spr = L.stages / rings;     // stages per ring
  const int hd = padded(h);
  const int unit_rows = rings == 1 ? 2 * WG_ROWS : WG_ROWS;
  const int n_units = (n + unit_rows - 1) / unit_rows;
  const int step = gridDim.x * rings;
  if (tid == 0) {
    for (int s = 0; s < spr * rings; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], rings == 1 ? 8 : 4);   // one per consumer warp
    }
    for (int c = 0; c < 2; ++c) {
      mbar_init(&xfull[c], 1);
      mbar_init(&xempty[c], 4);
    }
    fence_barrier_init();
  }
  float* s_epi = reinterpret_cast<float*>(smem + L.off_epi);
  if (EPI != EPI_NONE) {
    const int nv = n_vec(EPI);
    for (int i = tid; i < nv * layers * hd; i += THREADS) {
      const int c = i % hd, vl = i / hd;
      const int v = vl / layers, l = vl - v * layers;
      const float* src = v == 0 ? e0 : v == 1 ? e1 : e2;
      s_epi[i] = c < h ? src[(size_t)l * h + c] : 0.f;
    }
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer: x tiles and every layer's weight chunks, per tile ----
    setmaxnreg_dec<24>();
    const int pw = (tid - 256) >> 5;
    if ((tid & 31) == 0 && pw < rings) {
      const int ring0 = pw * spr;
      const int total = layers * (hd / PASS) * (h / KCHUNK);
      int s = 0;
      uint32_t ph = 0, xph = 0;
      for (int u = blockIdx.x * rings + pw; u < n_units; u += step) {
        for (int c = rings == 1 ? 0 : pw; c < (rings == 1 ? 2 : pw + 1); ++c) {
          const int row0 = u * unit_rows + (rings == 1 ? c * WG_ROWS : 0);
          const int valid = max(0, min(WG_ROWS, n - row0));
          mbar_wait(&xempty[c], xph ^ 1);
          if (valid > 0) {
            const uint32_t bytes = (uint32_t)valid * h * 2;
            mbar_arrive_expect_tx(&xfull[c], bytes);
            bulk_copy_g2s(smem + L.off_x + (size_t)c * WG_ROWS * h * 2,
                          x + (size_t)row0 * h, bytes, &xfull[c]);
          } else {
            mbar_arrive(&xfull[c]);
          }
        }
        xph ^= 1;
        for (int g = 0; g < total; ++g) {
          mbar_wait(&empty[ring0 + s], ph ^ 1);
          mbar_arrive_expect_tx(&full[ring0 + s], STAGE_BYTES);
          bulk_copy_g2s(smem + L.off_w + (size_t)(ring0 + s) * STAGE_BYTES,
                        wdev + (size_t)g * PASS * KCHUNK, STAGE_BYTES,
                        &full[ring0 + s]);
          if (++s == spr) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers ----------------------------------------------------------
  setmaxnreg_inc<240>();
  const int cw = tid >> 7;   // consumer warpgroup 0 / 1
  const int warp = (tid & 127) >> 5;
  const int ring = rings == 1 ? 0 : cw;
  Consumer C;
  C.full = full + ring * spr;
  C.empty = empty + ring * spr;
  C.stage0 = smem_u32(smem + L.off_w + ring * spr * STAGE_BYTES);
  C.stages = spr;
  C.lane = tid & 31;
  C.t = C.lane & 3;
  const int r_lo = warp * 16 + (C.lane >> 2), r_hi = r_lo + 8;
  const bf16* s_x = reinterpret_cast<const bf16*>(smem + L.off_x) + cw * WG_ROWS * h;
  const int nkb = h / 16, passes = hd / PASS;
  const bool pingpong = mode == MODE_ILV2;

  Pipe p = {0, 0u, -1};
  float acc[PASS / 2];
  uint32_t frag[64], fout[64];
#pragma unroll
  for (int i = 0; i < PASS / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) frag[i] = fout[i] = 0u;
  // consumer 0 issues first: the barrier it waits on has one phase's
  // arrivals from consumer 1 already
  if (pingpong && cw == 1) named_barrier_arrive(1, 256);

  uint32_t xph = 0;
  for (int u = blockIdx.x * rings + (rings == 1 ? 0 : cw); u < n_units;
       u += step) {
    const int row0 = u * unit_rows + (rings == 1 ? cw * WG_ROWS : 0);
    const bool last_unit = u + step >= n_units;
    // layer 0's A fragments from the x tile (its buffer is released once
    // the first pass's products have consumed them)
    mbar_wait(&xfull[cw], xph);
    xph ^= 1;
    // every block is loaded, those past the width from block 0 (a select,
    // not a branch: a load that feeds a wgmma on a divergent path makes
    // ptxas serialize all of them); they are never multiplied
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = (j < nkb ? 16 * j : 0) + 2 * C.t;
      const bf16* lo = s_x + r_lo * h + col;
      const bf16* hi = s_x + r_hi * h + col;
      frag[4 * j] = *reinterpret_cast<const uint32_t*>(lo);
      frag[4 * j + 1] = *reinterpret_cast<const uint32_t*>(hi);
      frag[4 * j + 2] = *reinterpret_cast<const uint32_t*>(lo + 8);
      frag[4 * j + 3] = *reinterpret_cast<const uint32_t*>(hi + 8);
    }

    for (int l = 0; l < layers; ++l) {
      const float* v0 = s_epi + (size_t)l * hd;
      const float* v1 = s_epi + (size_t)(layers + l) * hd;
      const float* v2 = s_epi + (size_t)(2 * layers + l) * hd;
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        if (pass < passes) {
          if (pingpong) named_barrier(1 + cw, 256);
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (j < nkb) C.mma(acc, frag + 4 * j, j, nkb, p);
          }
          // the other consumer's turn; consumer 1's last turn has no
          // successor
          if (pingpong &&
              !(cw == 1 && last_unit && l == layers - 1 && pass == passes - 1))
            named_barrier_arrive(2 - cw, 256);
          wgmma_wait<0>();
          fence_regs<PASS / 2>(acc);
          if (C.lane == 0) mbar_arrive(&C.empty[p.prev]);
          p.prev = -1;
          // the x tile was read into registers that these products
          // consumed: its buffer may take the next tile's (the bulk copy
          // must not overtake a read still in flight)
          if (l == 0 && pass == 0 && C.lane == 0) mbar_arrive(&xempty[cw]);
          epilogue<EPI>(acc, fout + pass * (PASS / 4), v0, v1, v2, pass * PASS,
                        C.t);
        }
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) frag[i] = fout[i];
    }

    // the last layer, bf16, from registers; rows past n are not stored
    const bool whole = row0 + WG_ROWS <= n;
    const bool ok_lo = whole || row0 + r_lo < n;
    const bool ok_hi = whole || row0 + r_hi < n;
    bf16* o_lo = out + (size_t)(row0 + r_lo) * h + 2 * C.t;
    bf16* o_hi = out + (size_t)(row0 + r_hi) * h + 2 * C.t;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < nkb) {
        if (ok_lo) {
          *reinterpret_cast<uint32_t*>(o_lo + 16 * j) = frag[4 * j];
          *reinterpret_cast<uint32_t*>(o_lo + 16 * j + 8) = frag[4 * j + 2];
        }
        if (ok_hi) {
          *reinterpret_cast<uint32_t*>(o_hi + 16 * j) = frag[4 * j + 1];
          *reinterpret_cast<uint32_t*>(o_hi + 16 * j + 8) = frag[4 * j + 3];
        }
      }
    }
  }
}

int g_num_sms = 0;

template <int EPI>
int launch(const bf16* x, const bf16* wdev, const float* e0, const float* e1,
           const float* e2, bf16* out, int n, int h, int layers, int mode,
           cudaStream_t stream) {
  const int smem = make_layout(h, layers, EPI).total + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (g_num_sms == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&g_num_sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = (n + 2 * WG_ROWS - 1) / (2 * WG_ROWS);
  const int blocks = tiles < g_num_sms ? tiles : g_num_sms;
  chain_kernel<EPI><<<blocks, THREADS, smem, stream>>>(x, wdev, e0, e1, e2,
                                                       out, n, h, layers, mode);
  return (int)cudaGetLastError();
}

bool covered(int h, int layers, int epi) {
  return h >= 64 && h <= 2 * PASS && h % 64 == 0 && layers >= 1 &&
         epi >= EPI_NONE && epi <= EPI_FOLD &&
         make_layout(h, layers, epi).stages >= MIN_STAGES;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA, alignment slack included, and its
// weight stages (ops/mxu_chain.py::chain_smem / chain_stages mirror them).
int mxu_chain_smem(int h, int layers, int epi) {
  return make_layout(h, layers, epi).total + 1024;
}
int mxu_chain_stages(int h, int layers, int epi) {
  return make_layout(h, layers, epi).stages;
}

// The weights' device layout: wdev (layers * padded(h) * h) bf16 from w
// (layers, h, h) bf16; with fold, scaled by bf16(f) per output column, and
// q (layers, h) = f * b + p. Launches on `stream`.
int mxu_chain_pack(const void* w, const void* b, const void* f, const void* p,
                   void* wdev, void* q, int h, int layers, int fold,
                   void* stream) {
  if (h < 64 || h > 2 * PASS || h % 64 != 0 || layers < 1)
    return (int)cudaErrorInvalidValue;
  pack_kernel<<<264, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)w, (const float*)b, (const float*)f, (const float*)p, h,
      layers, fold, (bf16*)wdev, (float*)q);
  return (int)cudaGetLastError();
}

// x (n, h) bf16 through `layers` layers of w (layers, h, h) bf16 into out
// (n, h) bf16. epi: 0 none, 1 FiLM (b, f, p: (layers, h) f32), 2 fold (the
// same inputs); wdev (layers * padded(h) * h bf16) and, for fold, q
// ((layers, h) f32) are scratch the pack fills first. tile / interleave:
// (64, 1), (128, 1) or (128, 2). Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
int mxu_chain_forward(const void* x, const void* w, const void* b,
                      const void* f, const void* p, void* wdev, void* q,
                      void* out, int n, int h, int layers, int tile,
                      int interleave, int epi, void* stream) {
  const int mode = tile == 64 && interleave == 1    ? MODE_T64
                   : tile == 128 && interleave == 1 ? MODE_T128
                   : tile == 128 && interleave == 2 ? MODE_ILV2
                                                    : -1;
  if (mode < 0 || n < 1 || !covered(h, layers, epi) ||
      ((uintptr_t)x & 15) != 0 || ((uintptr_t)out & 3) != 0)
    return (int)cudaErrorInvalidValue;
  int rc = mxu_chain_pack(w, b, f, p, wdev, q, h, layers, epi == EPI_FOLD,
                          stream);
  if (rc != 0) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* xx = (const bf16*)x;
  const bf16* wd = (const bf16*)wdev;
  bf16* o = (bf16*)out;
  if (epi == EPI_NONE)
    return launch<EPI_NONE>(xx, wd, nullptr, nullptr, nullptr, o, n, h,
                            layers, mode, s);
  if (epi == EPI_FILM)
    return launch<EPI_FILM>(xx, wd, (const float*)b, (const float*)f,
                            (const float*)p, o, n, h, layers, mode, s);
  return launch<EPI_FOLD>(xx, wd, (const float*)q, nullptr, nullptr, o, n, h,
                          layers, mode, s);
}

const char* mxu_chain_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
