// The field's 512-wide ceiling probe for NVIDIA Hopper (sm_90a): the bf16
// chain a <- bf16(a @ W[i]) (bf16 operands, f32 accumulation, the output
// rounded to bf16, round to nearest even) at widths up to 512: the FLOPs
// per point of the 11-layer chain at 256 in 5 wider products.
//
// Replaces the Pallas TPU kernel scripts/profile_mxu_chain.py::run_wide
// (pallas_call at :102).
//
// What bounds it on the card: operations. 2 * n * h^2 * layers FLOPs
// against 2 * n * h * 2 bytes of activations in and out; at n = 2^19,
// h = 512, 5 layers that is 1.37 TFLOP against 1.07 GB, far above the
// H100's ~295 FLOP/byte ridge.
//
// Design (the building blocks are in hopper.cuh):
//   * products: wgmma m64n128k16 with A from shared memory. At width 512 a
//     64-row A operand would be 256 registers a thread, so each consumer
//     warpgroup keeps its 64 x h activation tile once in shared memory, in
//     the 128-byte-swizzled K-major layout (h / 64 blocks of 64 rows x 64 K,
//     8 KB each); a k16 step moves A's descriptor by 32 bytes, as B's;
//   * shared memory: the two consumers' tiles take 128 KB at width 512, so
//     there is no second activation buffer. A layer runs as up to four
//     128-column passes over the whole K; the bf16 outputs of all but the
//     last pass wait in registers (32 each), and once the layer's last
//     products have retired in every warp of the warpgroup (wgmma_wait<0>
//     and its named barrier) they are written over A, then
//     fence.proxy.async orders them before the next layer's wgmma reads;
//   * weights: chain_pack.cuh's pack_kernel (launched by the same entry
//     point, in the same stream) writes 16 KB chunks of 128 output columns
//     x 64 K in wgmma's swizzled B layout, the format of mxu_chain.cu; one
//     elected lane of the producer warpgroup per ring bulk-copies them onto
//     mbarriers, a ring of the 6 stages (96 KB) left beside the tiles at
//     width 512 (up to 8 at narrower widths);
//   * x in, out out: by 2-D tensor copies (TMA with the 128-byte swizzle:
//     one 64-row x 64-column box is one A block, already in wgmma's layout)
//     issued by another elected producer lane per consumer, so the
//     consumers spend no instructions and no registers on them. In the
//     unit's last pass, as K chunk b's products retire in every warp, the
//     consumers write the earlier passes' output block b over A block b
//     and signal it on an mbarrier; the lane stores it, waits until the
//     store has read it, and loads the next unit's x block b in its place.
//     Layer 0 of the next unit waits for each x block at its first use.
//     Out-of-bounds rows load as zeros and are not stored;
//   * one persistent CTA per SM: the producer warpgroup and two consumer
//     warpgroups of 64 rows. Tile 128 (the default): both consumers take
//     the two halves of one 128-row tile and every weight stage feeds
//     both, so each CTA streams the weights from L2 once per 128 rows
//     (10.7 GB per call at 2^19 rows). Tile 64: each consumer walks its
//     own 64-row tiles on its own half of the ring (twice the L2 stream).
//     Both give the same bits: every row's products run in the same order;
//   * registers: setmaxnreg gives the consumers 240 (a 64 x 128 f32
//     accumulator and three passes' bf16 outputs, 64 + 96) and the
//     producer 24.
//
// The plain torch version is fenerf_tpu_torch/ops/mxu_chain.py::
// chain_reference; pack_chain_weights writes the same bytes as the pack.

#include "chain_pack.cuh"
#include "hopper.cuh"

#include <cudaTypedefs.h>   // CUtensorMap, cuTensorMapEncodeTiled's type
#include <stddef.h>
#include <stdint.h>

using namespace hopper;
typedef __nv_bfloat16 bf16;

namespace {

using chain_pack::KCHUNK;
using chain_pack::PASS;
using chain_pack::padded;

constexpr int THREADS = 384;         // 2 consumer warpgroups + the producer
constexpr int WG_ROWS = 64;          // rows per consumer warpgroup
constexpr int MAX_H = 512;
constexpr int MAX_PASSES = MAX_H / PASS;
constexpr int MAX_KB = MAX_H / 16;   // k16 steps of a pass at width 512
constexpr int MAX_NCH = MAX_H / KCHUNK;   // K chunks, A blocks
constexpr int STAGE_BYTES = PASS * KCHUNK * 2;
constexpr int BLOCK_BYTES = WG_ROWS * KCHUNK * 2;   // one 64-K block of A
constexpr int MAX_STAGES = 8;
// at tile 64 each consumer's ring holds the chunk being read and the one
// whose products are still in flight
constexpr int MIN_STAGES = 4;
constexpr int MAX_SMEM = 232448 - 1024;   // less the alignment slack

// T64: each consumer its own 64-row tiles and ring; T128: both on one
// 128-row tile and one ring
enum { MODE_T64 = 0, MODE_T128 = 1 };

struct Layout {
  int stages, off_w, off_a, total;
};

// [mbarriers | weight stages (1024-aligned) | the two consumers' A tiles]
__host__ __device__ inline Layout make_layout(int h) {
  Layout L;
  const int a_bytes = 2 * WG_ROWS * h * 2;
  L.off_w = 1024;
  const int st = (MAX_SMEM - 1024 - a_bytes) / STAGE_BYTES;
  L.stages = st < MAX_STAGES ? st : MAX_STAGES;
  L.off_a = L.off_w + L.stages * STAGE_BYTES;
  L.total = L.off_a + a_bytes;
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
  uint32_t a0;       // shared address of this consumer's A tile
  int stages;
  int lane;

  // k16 step kb of a pass: the chunk's stage is waited for at its first
  // step; at its last, the previous chunk's products are waited for and
  // its stage released (one chunk of products stays in flight)
  __device__ __forceinline__ void mma(float* acc, int kb, Pipe& p) const {
    const int kp = kb & 3;
    if (kp == 0) mbar_wait(&full[p.s], p.ph);
    const uint32_t a = a0 + (kb >> 2) * BLOCK_BYTES + kp * 32;
    const uint32_t b = stage0 + p.s * STAGE_BYTES + kp * 32;
    wgmma_fence();
    Wgmma<PASS>::template ss<0, 0>(acc, desc_sw128(a, 16, 1024),
                                   desc_sw128(b, 16, 1024), kb);
    if (kp == 3) {
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

  // the end of a pass: its products retired, its last stage released
  __device__ __forceinline__ void finish(float* acc, Pipe& p) const {
    wgmma_wait<0>();
    fence_regs<PASS / 2>(acc);
    if (lane == 0) mbar_arrive(&empty[p.prev]);
    p.prev = -1;
  }
};

// a pass's accumulator as bf16 pairs: v[2j] row lo, v[2j + 1] row hi, both
// at columns 8j + 2t, + 1
__device__ __forceinline__ void to_bf16(const float* acc, uint32_t* v) {
#pragma unroll
  for (int j = 0; j < PASS / 8; ++j) {
    v[2 * j] = pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
    v[2 * j + 1] = pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// pass ps's bf16 outputs at j in [j0, j1) into the swizzled A tile
// (columns below h): a warp's 32 stores of one j fall in 32 distinct banks
__device__ __forceinline__ void put_a(unsigned char* a, const uint32_t* v,
                                      int ps, int j0, int j1, int h,
                                      int r_lo, int t) {
#pragma unroll
  for (int j = 0; j < PASS / 8; ++j) {
    const int col = ps * PASS + 8 * j;
    if (j >= j0 && j < j1 && col < h) {
      unsigned char* row = a + (col >> 6) * BLOCK_BYTES + r_lo * 128 +
                           (((j ^ r_lo) & 7) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(row) = v[2 * j];
      *reinterpret_cast<uint32_t*>(row + 8 * 128) = v[2 * j + 1];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
wide_kernel(const __grid_constant__ CUtensorMap tmx,
            const __grid_constant__ CUtensorMap tmo,
            const bf16* __restrict__ wdev, int n, int h, int layers,
            int mode) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled stages and tiles need 1024-byte alignment (the launch
  // adds the slack)
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Layout L = make_layout(h);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* xfull = empty + MAX_STAGES;   // [consumer][block]: x landed
  uint64_t* ofull = xfull + 2 * MAX_NCH;  // [consumer][block]: out written
  const int tid = threadIdx.x;
  const int rings = mode == MODE_T64 ? 2 : 1;
  const int spr = L.stages / rings;     // stages per ring
  const int passes = padded(h) / PASS;
  const int nch = h / KCHUNK;
  const int unit_rows = rings == 1 ? 2 * WG_ROWS : WG_ROWS;
  const int n_units = (n + unit_rows - 1) / unit_rows;
  const int step = gridDim.x * rings;
  if (tid == 0) {
    for (int s = 0; s < spr * rings; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], rings == 1 ? 8 : 4);   // one per consumer warp
    }
    for (int i = 0; i < 2 * MAX_NCH; ++i) {
      mbar_init(&xfull[i], 1);
      mbar_init(&ofull[i], 128);   // every thread of the consumer
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {
    setmaxnreg_dec<24>();
    const int pw = (tid - 256) >> 5;
    if ((tid & 31) != 0) return;
    if (pw < rings) {
      // ---- every layer's weight chunks, once per unit ------------------
      const int ring0 = pw * spr;
      const int total = layers * passes * nch;
      int s = 0;
      uint32_t ph = 0;
      for (int u = blockIdx.x * rings + pw; u < n_units; u += step) {
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
    } else if (pw >= 2) {
      // ---- consumer c's x tiles in and outputs out, block by block -----
      const int c = pw - 2;
      unsigned char* a = smem + L.off_a + c * WG_ROWS * h * 2;
      uint64_t* xf = xfull + c * MAX_NCH;
      uint64_t* of = ofull + c * MAX_NCH;
      const int row_off = rings == 1 ? c * WG_ROWS : 0;
      int k = 0, prev = 0;
      for (int u = blockIdx.x * rings + (rings == 1 ? 0 : c); u < n_units;
           u += step, ++k) {
        const int row0 = u * unit_rows + row_off;
        for (int b = 0; b < nch; ++b) {
          if (k > 0) {
            // the last unit's output block b, then its place is free
            mbar_wait(&of[b], (k - 1) & 1);
            tma_store_2d(&tmo, b * KCHUNK, prev, a + b * BLOCK_BYTES);
            bulk_commit();
            bulk_wait_read<0>();
          }
          mbar_arrive_expect_tx(&xf[b], BLOCK_BYTES);
          tma_load_2d(a + b * BLOCK_BYTES, &tmx, b * KCHUNK, row0, &xf[b]);
        }
        prev = row0;
      }
      if (k > 0) {
        for (int b = 0; b < nch; ++b) {
          mbar_wait(&of[b], (k - 1) & 1);
          tma_store_2d(&tmo, b * KCHUNK, prev, a + b * BLOCK_BYTES);
        }
        bulk_commit();
        bulk_wait_all();
      }
    }
    return;
  }

  // ---- consumers ----------------------------------------------------------
  setmaxnreg_inc<240>();
  const int cw = tid >> 7;   // consumer warpgroup 0 / 1
  const int it = tid & 127;
  const int ring = rings == 1 ? 0 : cw;
  unsigned char* a = smem + L.off_a + cw * WG_ROWS * h * 2;
  uint64_t* xf = xfull + cw * MAX_NCH;
  uint64_t* of = ofull + cw * MAX_NCH;
  Consumer C;
  C.full = full + ring * spr;
  C.empty = empty + ring * spr;
  C.stage0 = smem_u32(smem + L.off_w + ring * spr * STAGE_BYTES);
  C.a0 = smem_u32(a);
  C.stages = spr;
  C.lane = tid & 31;
  const int t = C.lane & 3;
  const int r_lo = (it >> 5) * 16 + (C.lane >> 2);
  const int nkb = h / 16;
  const int bar = 1 + cw;   // this warpgroup's named barrier

  Pipe p = {0, 0u, -1};
  float acc[PASS / 2];
  uint32_t held[MAX_PASSES][PASS / 4];   // the last pass stays in acc
#pragma unroll
  for (int i = 0; i < PASS / 2; ++i) acc[i] = 0.f;

  uint32_t xph = 0;
  for (int u = blockIdx.x * rings + (rings == 1 ? 0 : cw); u < n_units;
       u += step, xph ^= 1) {
    for (int l = 0; l < layers; ++l) {
      const bool last_layer = l == layers - 1;
#pragma unroll
      for (int ps = 0; ps < MAX_PASSES; ++ps) {
        if (ps < passes) {
          const bool tail = last_layer && ps == passes - 1;
#pragma unroll
          for (int kb = 0; kb < MAX_KB; ++kb) {
            if (kb < nkb) {
              // the unit's first pass reads each x block once it landed
              if (ps == 0 && (kb & 3) == 0 && l == 0)
                mbar_wait(&xf[kb >> 2], xph);
              C.mma(acc, kb, p);
              // the unit's last pass: once K chunk b's products have
              // retired in every warp, A block b takes the earlier
              // passes' output block b, which the producer stores
              const int b = (kb >> 2) - 1;
              if (tail && kb >= 4 && (kb & 3) == 3 && b < 2 * ps) {
                named_barrier(bar, 128);
                put_a(a, held[b >> 1], b >> 1, 8 * (b & 1), 8 * (b & 1) + 8,
                      h, r_lo, t);
                fence_proxy_async_smem();
                mbar_arrive(&of[b]);
              }
            }
          }
          C.finish(acc, p);
          if (ps < MAX_PASSES - 1 && ps < passes - 1) to_bf16(acc, held[ps]);
        }
      }
      uint32_t last[PASS / 4];
      to_bf16(acc, last);
      // every warp's products of this layer have retired: A may be
      // overwritten
      named_barrier(bar, 128);
      if (!last_layer) {
#pragma unroll
        for (int ps = 0; ps < MAX_PASSES - 1; ++ps) {
          if (ps < passes - 1)
            put_a(a, held[ps], ps, 0, PASS / 8, h, r_lo, t);
        }
        put_a(a, last, passes - 1, 0, PASS / 8, h, r_lo, t);
        fence_proxy_async_smem();
        named_barrier(bar, 128);
      } else {
        // the last pass's output blocks
        put_a(a, last, passes - 1, 0, PASS / 8, h, r_lo, t);
        fence_proxy_async_smem();
        for (int b = 2 * (passes - 1); b < nch; ++b) mbar_arrive(&of[b]);
      }
    }
  }
}

int g_num_sms = 0;
PFN_cuTensorMapEncodeTiled_v12000 g_encode = nullptr;

bool covered(int h, int layers) {
  return h >= 64 && h <= MAX_H && h % 64 == 0 && layers >= 1 &&
         make_layout(h).stages >= MIN_STAGES;
}

// (n, h) bf16 row-major as 64-row x 64-column boxes in the 128-byte swizzle
int encode(CUtensorMap* map, const void* base, int n, int h) {
  if (g_encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return (int)err;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    g_encode = (PFN_cuTensorMapEncodeTiled_v12000)fn;
  }
  cuuint64_t dims[2] = {(cuuint64_t)h, (cuuint64_t)n};
  cuuint64_t strides[1] = {(cuuint64_t)h * 2};
  cuuint32_t box[2] = {KCHUNK, WG_ROWS};
  cuuint32_t estr[2] = {1, 1};
  const CUresult r = g_encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA, alignment slack included, and its
// weight stages (ops/mxu_chain.py::wide_smem / wide_stages mirror them).
int mxu_wide_smem(int h) { return make_layout(h).total + 1024; }
int mxu_wide_stages(int h) { return make_layout(h).stages; }

// The weights' device layout: wdev (layers * padded(h) * h) bf16 from w
// (layers, h, h) bf16. Launches on `stream`.
int mxu_wide_pack(const void* w, void* wdev, int h, int layers,
                  void* stream) {
  if (!covered(h, layers)) return (int)cudaErrorInvalidValue;
  chain_pack::pack_kernel<<<264, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)w, nullptr, nullptr, nullptr, h, layers, 0, (bf16*)wdev,
      nullptr);
  return (int)cudaGetLastError();
}

// x (n, h) bf16 through `layers` layers of w (layers, h, h) bf16 into out
// (n, h) bf16; wdev (layers * padded(h) * h bf16) is scratch the pack
// fills first. tile: 64 or 128 rows. Launches on `stream`; returns
// cudaGetLastError() (0 = launched) or the tensor maps' error.
int mxu_wide_forward(const void* x, const void* w, void* wdev, void* out,
                     int n, int h, int layers, int tile, void* stream) {
  const int mode = tile == 64 ? MODE_T64 : tile == 128 ? MODE_T128 : -1;
  if (mode < 0 || n < 1 || !covered(h, layers) ||
      ((uintptr_t)x & 15) != 0 || ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tmx, tmo;
  int rc = encode(&tmx, x, n, h);
  if (rc == 0) rc = encode(&tmo, out, n, h);
  if (rc == 0) rc = mxu_wide_pack(w, wdev, h, layers, stream);
  if (rc != 0) return rc;
  const int smem = mxu_wide_smem(h);
  cudaError_t err = cudaFuncSetAttribute(
      wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  wide_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      tmx, tmo, (const bf16*)wdev, n, h, layers, mode);
  return (int)cudaGetLastError();
}

const char* mxu_wide_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
