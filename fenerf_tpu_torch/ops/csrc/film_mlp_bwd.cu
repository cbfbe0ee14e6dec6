// Fused FiLM-SIREN field backward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fenerf_tpu/ops/film_mlp_grad.py::film_mlp_bwd
// (pallas_call at film_mlp_grad.py:343). For each point: recompute the
// forward from the saved inputs (keeping every FiLM layer's pre-sine y in
// f32), then the chain rule layer by layer, with the TPU kernel's roundings:
// bf16 operands and f32 accumulation in every product, f32 epilogues, cos as
// the polynomial sine of v + pi/2, the label head unfolded.
//
// What bounds it on the card: three passes of ~0.80 M multiply-adds per
// point for the flagship (recompute, dX, dW), ~4.8 MFLOP per point, so the
// tensor cores bound it in principle (0.72 ms at 147,456 points and 989
// TFLOP/s bf16). The TPU kernel sums dW/db/film gradients in output blocks
// that stay resident across its sequential grid; Hopper's blocks run in no
// order, and the 2.9 MB of f32 weight gradients fit in no block's memory.
// The per-layer y of a tile does not fit shared memory either. So the
// design pays device-memory traffic instead (~25 KB per point written and
// read, ~1.3 ms of HBM time at the G-phase shape):
//
//   (a) bwd_rows_kernel: one persistent CTA per SM walks 128-row tiles, each
//       inside one batch element; two consumer warpgroups own 64 rows each
//       and a producer warp streams the weights. It runs the step program
//       of ops/film_mlp_grad.py::pack_bwd (forward recompute steps, the head
//       seeds from g_out, backward steps) the way film_mlp.cu runs the
//       forward: every step's weights come as 64-row chunks in wgmma's
//       128-byte-swizzled K-major layout, one bulk copy per chunk onto an
//       mbarrier ring; wgmma m64nNk16 with A from registers; the epilogue
//       runs on the accumulators and turns them into the next step's A
//       fragments. The backward steps g <- dy W^T take W^T from the step
//       program, which already holds every backward step's transposed
//       weights (a second device layout, not the transpose bit), so every
//       product has the same form. s = cos(f y + p) g, dy = s f and the
//       column sums of s y, s and dy (dfreq, dphase, db) stay in registers;
//       the sums go per warp through shuffles, then per warpgroup in a
//       fixed order into per-(tile, warpgroup) partials. Each linear's
//       bf16 input x and bf16 dy go to scratch regions laid out
//       [region][row][width] in 64-row x 64-column blocks already swizzled
//       as the dW kernel's wgmma operands; each FiLM layer's f32 y to a
//       row-major region. A buffer that is not in registers when a step
//       reads it is read back from its region.
//   (b) dw_kernel: dW = x^T dy of one 64-column block of one layer's x
//       region over a row split of 4096 rows; both operands MN-major
//       (transpose bits) straight from the scratch blocks, one bulk copy of
//       each per 64-row chunk onto a ring of four stages; the two consumer
//       warpgroups take alternate chunks and add their 64 x N partials in a
//       fixed order. f32 partials per split.
//   (c) reduce_kernel: sums per-split / per-tile partials in a fixed order.
// No atomics: the result is the same from run to run.

#include "hopper.cuh"

#include <stddef.h>

using namespace hopper;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 128;
constexpr int WG_ROWS = 64;
constexpr int THREADS = 384;     // 2 consumer warpgroups + producer warpgroup
constexpr int PASS = 128;        // columns per pass (ops/film_mlp.py::PASS)
constexpr int MAX_STAGES = 8 * 128 / PASS;   // row kernel: 128 KB ring
constexpr int DW_STAGES = 4;
constexpr int STEP_INTS = 48;
constexpr int HEAD_INTS = 48;
constexpr int DW_INTS = 9;
constexpr int MAX_SMEM = 232448 - 1024;   // less the alignment slack
constexpr int DW_STAGE = 8192 + 256 * 128;  // x block + dy chunk of N <= 256

enum { BUF_IN = 0, BUF_A = 1, BUF_B = 2, BUF_S = 3 };
enum { E_FILM_FWD = 0, E_LIN_FWD, E_PRE, E_FILM_BWD, E_LIN_BWD, E_OUT };
// header fields (ops/film_mlp_grad.py::_HEAD_NAMES)
enum {
  H_N_FWD = 0, H_N_BWD, H_HIDDEN, H_G, H_L_GEO, H_L_APP, H_IN_WIDTH,
  H_MAX_N_PAD, H_Y_W, H_X_W, H_DY_W, H_PART_W, H_PHASE_OFF, H_XG_PTS,
  H_XG_DIRS, H_N_LABELS, H_LABEL_SIG, H_LBL_Y, H_LBL_DYG, H_LBL_DBP,
  H_LBL_COL, H_RGB_DIM, H_RGB_SIG, H_RGB_Y, H_RGB_DYG, H_RGB_DBP, H_RGB_COL,
  H_SIG_DYG, H_SIG_DBP, H_SMALL_W, H_OUT_DIM, H_DB_W,
  H_DEV_X_W, H_DEV_DY_W, H_DEV_Y_W, H_DEV_PTS_X, H_DEV_DG_X, H_DEV_DG_W,
  H_DEV_LBL_Y, H_DEV_LBL_Y_W, H_DEV_RGB_Y, H_DEV_RGB_Y_W, H_DEV_SIG_DY,
  H_DEV_LBL_DY, H_DEV_LBL_DY_W, H_DEV_RGB_DY, H_DEV_RGB_DY_W, H_MAX_N_DEV
};
// step fields (ops/film_mlp_grad.py::_bwd_plan)
enum {
  S_NSEG = 0, S_NPAD = 10, S_WOFF, S_BOFF, S_KIND, S_DST, S_UNUSED, S_FILM,
  S_CHUNK, S_NVALID, S_YOFF, S_XGOFF, S_DYGOFF, S_DBPOFF, S_FPOFF, S_TARGET,
  S_KTOTAL, S_NDEV, S_DOFF, S_NCHUNK, S_YDEV, S_YW, S_OUTDEV, S_OUTW,
  S_SEGCO, S_SEGW = S_SEGCO + 3, S_SEGARR = S_SEGW + 3
};
// dW work item fields (ops/film_mlp_grad.py::_DW_NAMES)
enum { D_XCO = 0, D_XW, D_XCOL, D_DYCO, D_DYW, D_DWOFF, D_WROW, D_ROWS,
       D_NPAD };

__host__ __device__ inline int align_up(int x, int a) {
  return (x + a - 1) / a * a;
}

// element offset of (row, col) in a tiled bf16 scratch region: column
// offset co of a [rows_total][width] array, 64 x 64 swizzled blocks
__device__ __forceinline__ size_t tiled(int co, int w, size_t rows_total,
                                        size_t row, int col) {
  return (size_t)co * rows_total + (row >> 6) * 64 * (size_t)w
         + (size_t)(col >> 6) * 4096
         + (sw128_offset((int)(row & 63), col & 63) >> 1);
}

struct Layout {
  int stages, stage_bytes, off_w, in_pitch, off_in, s_pitch, off_s, off_part,
      off_row, off_bias, off_tab, total;
};

// [mbarriers | weight stages (1024-aligned) | input tiles | small buffers |
//  column-sum partials | row ids | biases | the tile's FiLM tables], per
// consumer warpgroup where per row
__host__ __device__ inline Layout make_layout(const int* hd, int n_bias) {
  Layout L;
  L.stage_bytes = (hd[H_MAX_N_DEV] < PASS ? hd[H_MAX_N_DEV] : PASS) * 128;
  L.in_pitch = hd[H_IN_WIDTH] + 8;
  L.s_pitch = hd[H_SMALL_W] + 8;
  const int in_bytes = align_up(2 * WG_ROWS * L.in_pitch * 2, 128);
  const int s_bytes = align_up(2 * WG_ROWS * L.s_pitch * 2, 128);
  const int part_bytes = 2 * 4 * 3 * 256 * 4;
  const int row_bytes = 2 * WG_ROWS * 4;
  const int bias_bytes = align_up(n_bias * 4, 128);
  const int tab_bytes = (hd[H_L_GEO] + hd[H_L_APP]) * 2 * hd[H_HIDDEN] * 4;
  const int rest = in_bytes + s_bytes + part_bytes + row_bytes + bias_bytes
                   + tab_bytes;
  L.off_w = 1024;
  const int st = (MAX_SMEM - 1024 - rest) / L.stage_bytes;
  L.stages = st < MAX_STAGES ? st : MAX_STAGES;
  L.off_in = L.off_w + L.stages * L.stage_bytes;
  L.off_s = L.off_in + in_bytes;
  L.off_part = L.off_s + s_bytes;
  L.off_row = L.off_part + part_bytes;
  L.off_bias = L.off_row + row_bytes;
  L.off_tab = L.off_bias + bias_bytes;
  L.total = L.off_tab + tab_bytes;
  return L;
}

// fenerf_tpu/ops/film_mlp_grad.py::_fcos: the sine of v + pi/2
__device__ __forceinline__ float fast_cos(float v) {
  return fast_sin(__fadd_rn(v, 1.5707963267948966f));
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// sum over the 8 lanes of a warp that share lane % 4 (the rows g of an
// accumulator), a fixed order
__device__ __forceinline__ float rowsum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 16);
  return x;
}

struct Pipe {
  int s;
  uint32_t ph;
  int prev;
};

struct RowConsumer {
  const int* hd;
  const float* gout;
  const float* s_bias;   // every recompute step's biases
  const float* s_tab;    // the tile's [l_geo + l_app][hidden / 2][f f p p]
  float* yscr;
  bf16* xscr;
  bf16* dyscr;
  float* dpts;
  float* ddirs;
  float* dgf;
  size_t rows_total;
  int hidden, g, l_geo, out_dim;
  uint64_t* full;
  uint64_t* empty;
  uint32_t stage0;
  int stage_bytes, stages;
  const bf16* s_in;
  int in_pitch;
  bf16* s_s;
  int s_pitch;
  float* s_part;   // this warpgroup's [4 warps][3][256]
  int bar;         // its named barrier
  // this thread
  int ltid, warp, lane, t, r_lo, r_hi;
  // the tile
  int batch;
  bool ok_lo, ok_hi;       // rows inside the batch element
  size_t in_lo, in_hi;     // their input rows
  size_t sr_lo, sr_hi;     // their scratch rows
  float* part;             // this (tile, warpgroup)'s partials

  // A fragment of K block [col, col + 16) of a segment read from memory:
  // the input tile or the small buffer in shared memory, or a tiled
  // scratch region this thread wrote itself. The addresses are selected,
  // not branched on, so no load that feeds wgmma sits on a divergent path
  // (which would make ptxas serialize every product of the kernel).
  __device__ __forceinline__ void load_a(const int* d, int s, int col,
                                         uint32_t* a) const {
    const int src = d[1 + 3 * s];
    const bool sm = src == BUF_IN || src == BUF_S;
    const bf16* base = src == BUF_IN ? s_in : s_s;
    const int pitch = src == BUF_IN ? in_pitch : s_pitch;
    const bf16* arr = d[S_SEGARR + s] ? dyscr : xscr;
    const int co = sm ? 0 : d[S_SEGCO + s];
    const int w = sm ? 64 : d[S_SEGW + s];
    const int c = col + 2 * t;
    const bf16* q0 = sm ? base + r_lo * pitch + c
                        : arr + tiled(co, w, rows_total, sr_lo, c);
    const bf16* q1 = sm ? base + r_hi * pitch + c
                        : arr + tiled(co, w, rows_total, sr_hi, c);
    const bf16* q2 = sm ? q0 + 8
                        : arr + tiled(co, w, rows_total, sr_lo, c + 8);
    const bf16* q3 = sm ? q1 + 8
                        : arr + tiled(co, w, rows_total, sr_hi, c + 8);
    a[0] = *reinterpret_cast<const uint32_t*>(q0);
    a[1] = *reinterpret_cast<const uint32_t*>(q1);
    a[2] = *reinterpret_cast<const uint32_t*>(q2);
    a[3] = *reinterpret_cast<const uint32_t*>(q3);
  }

  template <int N>
  __device__ __forceinline__ void mma(float* acc, const uint32_t* a, int kb,
                                      int nkb, Pipe& p) const {
    const int kp = kb & 3;
    if (kp == 0) mbar_wait(&full[p.s], p.ph);
    const uint32_t addr = stage0 + p.s * stage_bytes + kp * 32;
    wgmma_fence();
    Wgmma<N>::template rs<0>(acc, a, desc_sw128(addr, 16, 1024), kb);
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

  // one step: PASSES column passes of NP columns each (NP = min(n_dev,
  // 128)), every pass over the whole K; the passes' epilogues fill `fout`,
  // which becomes the registers' buffer at the end
  template <int NP, int PASSES>
  __device__ __forceinline__ void step(const int* d, float* acc,
                                       uint32_t* frag, uint32_t* fout,
                                       Pipe& p) const {
    const int n_seg = d[S_NSEG];
    const int nkb = d[S_KTOTAL] >> 4;
    const int kind = d[S_KIND];
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      int kb = 0;
      for (int s = 0; s < n_seg; ++s) {
        const int src = d[1 + 3 * s], col = d[2 + 3 * s];
        const int sk = d[3 + 3 * s] >> 4;
        const int co = d[S_SEGCO + s];
        if (src == BUF_IN || src == BUF_S || co >= 0) {
          for (int j = 0; j < sk; ++j) {
            uint32_t a[4];
            load_a(d, s, col + 16 * j, a);
            mma<NP>(acc, a, kb, nkb, p);
            // `a` is read by the product after issue: let it finish before
            // the next block reuses the registers
            wgmma_commit();
            wgmma_wait<0>();
            ++kb;
          }
        } else {   // the buffer in registers
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (j < sk) {
              mma<NP>(acc, frag + 4 * j, kb, nkb, p);
              ++kb;
            }
          }
        }
      }
      wgmma_wait<0>();
      fence_regs<NP / 2>(acc);
      if (lane == 0) mbar_arrive(&empty[p.prev]);
      p.prev = -1;
      uint32_t* fo = fout + pass * (NP / 4);
      if (kind <= E_PRE) {
        epilogue_fwd<NP>(d, acc, fo, pass * NP);
      } else if (kind <= E_LIN_BWD) {
        epilogue_bwd<NP>(d, acc, fo, pass * NP);
      } else {
        epilogue_out<NP>(d, acc, pass * NP);
      }
    }
    if (kind == E_FILM_BWD || kind == E_LIN_BWD) column_sums(d);
    if (kind == E_PRE || kind == E_OUT) return;
#pragma unroll
    for (int i = 0; i < PASSES * NP / 4; ++i) frag[i] = fout[i];
  }

  __device__ __forceinline__ void put_bf16x2(bf16* arr, int co, int w,
                                             size_t row, int c, float a,
                                             float b) const {
    *reinterpret_cast<uint32_t*>(arr + tiled(co, w, rows_total, row, c)) =
        pack_bf16x2(a, b);
  }

  // recompute: v = x W + b; E_FILM_FWD keeps y and applies the FiLM sine,
  // E_PRE keeps y only; the layer output goes to registers and its region
  template <int N>
  __device__ __forceinline__ void epilogue_fwd(const int* d, float* acc,
                                               uint32_t* fr, int c0) const {
    const int kind = d[S_KIND];
    const int n_pad = d[S_NPAD];
    const float* bias = s_bias + d[S_BOFF];
    const int fi = d[S_FILM];
    const float* ft = s_tab + ((fi == 0 ? 0 : l_geo) + d[S_CHUNK]) * 2 * hidden;
    const int y_co = d[S_YDEV], y_w = d[S_YW];
    const int o_co = d[S_OUTDEV], o_w = d[S_OUTW];
    float* ylo = yscr + (size_t)(y_co < 0 ? 0 : y_co) * rows_total
                 + sr_lo * y_w;
    float* yhi = yscr + (size_t)(y_co < 0 ? 0 : y_co) * rows_total
                 + sr_hi * y_w;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = c0 + 8 * j + 2 * t;
      const bool in = c < n_pad;
      float2 b = make_float2(0.f, 0.f);
      if (in) b = *reinterpret_cast<const float2*>(bias + c);
      float v0 = ok_lo ? acc[4 * j] + b.x : 0.f;
      float v1 = ok_lo ? acc[4 * j + 1] + b.y : 0.f;
      float v2 = ok_hi ? acc[4 * j + 2] + b.x : 0.f;
      float v3 = ok_hi ? acc[4 * j + 3] + b.y : 0.f;
      if (kind != E_LIN_FWD && in) {
        *reinterpret_cast<float2*>(ylo + c) = make_float2(v0, v1);
        *reinterpret_cast<float2*>(yhi + c) = make_float2(v2, v3);
      }
      if (kind == E_FILM_FWD) {
        if (in) {
          const float4 fq = *reinterpret_cast<const float4*>(ft + 2 * c);
          const float2 f = make_float2(fq.x, fq.y);
          const float2 q = make_float2(fq.z, fq.w);
          if (ok_lo) {
            v0 = fast_sin(f.x * v0 + q.x);
            v1 = fast_sin(f.y * v1 + q.y);
          }
          if (ok_hi) {
            v2 = fast_sin(f.x * v2 + q.x);
            v3 = fast_sin(f.y * v3 + q.y);
          }
        } else {
          v0 = v1 = v2 = v3 = 0.f;
        }
      }
      if (kind != E_PRE && in) {
        put_bf16x2(xscr, o_co, o_w, sr_lo, c, v0, v1);
        put_bf16x2(xscr, o_co, o_w, sr_hi, c, v2, v3);
      }
      acc[4 * j] = v0;
      acc[4 * j + 1] = v1;
      acc[4 * j + 2] = v2;
      acc[4 * j + 3] = v3;
    }
    if (kind != E_PRE) acc_to_afrag<N>(acc, fr);
  }

  // chain rule: E_FILM_BWD  s = cos(f y + p) g, dy = s f;  E_LIN_BWD dy = g.
  // dy goes to registers and its region; the column sums of s y, s and dy
  // over the warpgroup's rows to the partials
  template <int N>
  __device__ __forceinline__ void epilogue_bwd(const int* d, float* acc,
                                               uint32_t* fr, int c0) const {
    const bool film = d[S_KIND] == E_FILM_BWD;
    const int n_pad = d[S_NPAD];
    const int fi = d[S_FILM];
    const float* ft = s_tab + ((fi == 0 ? 0 : l_geo) + d[S_CHUNK]) * 2 * hidden;
    const int y_co = d[S_YDEV], y_w = d[S_YW];
    const int o_co = d[S_OUTDEV], o_w = d[S_OUTW];
    const float* ylo = yscr + (size_t)(y_co < 0 ? 0 : y_co) * rows_total
                       + sr_lo * y_w;
    const float* yhi = yscr + (size_t)(y_co < 0 ? 0 : y_co) * rows_total
                       + sr_hi * y_w;
    float* sp = s_part + warp * 3 * 256;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = c0 + 8 * j + 2 * t;
      const bool in = c < n_pad;
      float s[4] = {0.f, 0.f, 0.f, 0.f}, y[4] = {0.f, 0.f, 0.f, 0.f};
      float dy[4];
      if (film) {
        if (in) {
          const float4 fq = *reinterpret_cast<const float4*>(ft + 2 * c);
          const float2 f = make_float2(fq.x, fq.y);
          const float2 q = make_float2(fq.z, fq.w);
          const float2 a = *reinterpret_cast<const float2*>(ylo + c);
          const float2 b = *reinterpret_cast<const float2*>(yhi + c);
          y[0] = a.x; y[1] = a.y; y[2] = b.x; y[3] = b.y;
          const float ff[4] = {f.x, f.y, f.x, f.y};
          const float qq[4] = {q.x, q.y, q.x, q.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = e < 2 ? ok_lo : ok_hi;
            s[e] = ok ? fast_cos(ff[e] * y[e] + qq[e]) * acc[4 * j + e] : 0.f;
            dy[e] = s[e] * ff[e];
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) dy[e] = 0.f;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dy[e] = (in && (e < 2 ? ok_lo : ok_hi)) ? acc[4 * j + e] : 0.f;
      }
      if (in) {
        put_bf16x2(dyscr, o_co, o_w, sr_lo, c, dy[0], dy[1]);
        put_bf16x2(dyscr, o_co, o_w, sr_hi, c, dy[2], dy[3]);
      }
      // every lane shuffles (columns past n_pad carry zeros)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sd = rowsum8(dy[e] + dy[e + 2]);
        float sy = 0.f, ss = 0.f;
        if (film) {
          sy = rowsum8(s[e] * y[e] + s[e + 2] * y[e + 2]);
          ss = rowsum8(s[e] + s[e + 2]);
        }
        if (lane < 4 && in) {
          sp[c + e] = sy;
          sp[256 + c + e] = ss;
          sp[512 + c + e] = sd;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] = dy[e];
    }
    acc_to_afrag<N>(acc, fr);
  }

  // the per-(tile, warpgroup) partials of a backward step: the four warps'
  // column sums in order
  __device__ __forceinline__ void column_sums(const int* d) const {
    const bool film = d[S_KIND] == E_FILM_BWD;
    const int n_pad = d[S_NPAD];
    named_barrier(bar, 128);
    const int dbp = d[S_DBPOFF], fp = d[S_FPOFF];
    for (int c = ltid; c < n_pad; c += 128) {
      float sum[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        sum[k] = ((s_part[(0 * 3 + k) * 256 + c]
                   + s_part[(1 * 3 + k) * 256 + c])
                  + s_part[(2 * 3 + k) * 256 + c])
                 + s_part[(3 * 3 + k) * 256 + c];
      part[dbp + c] = sum[2];
      if (film) {
        part[fp + c] = sum[0];
        part[fp + hd[H_PHASE_OFF] + c] = sum[1];
      }
    }
    named_barrier(bar, 128);   // s_part is free for the next step
  }

  // dpoints, or ddirs and dgf
  template <int N>
  __device__ __forceinline__ void epilogue_out(const int* d, const float* acc,
                                               int c0) const {
    const int target = d[S_TARGET];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int c = c0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const bool hi = (i & 2) != 0;
      if (!(hi ? ok_hi : ok_lo)) continue;
      const size_t R = hi ? in_hi : in_lo;
      if (target == 0) {
        if (c < 3) dpts[R * 3 + c] = acc[i];
      } else if (c < 3) {
        ddirs[R * 3 + c] = acc[i];
      } else if (c >= 16 && c - 16 < g) {
        dgf[R * g + (c - 16)] = acc[i];
      }
    }
  }

  // seeds of the backward: dy of the sigma, label and rgb heads from g_out
  // (sigmoid derivatives on the stored pre-activations), into the small
  // buffer and the heads' dy regions; pads and rows past the end 0; their
  // column sums (db of the heads) in row order
  __device__ void seed(const int* s_row, size_t sr0) const {
    const int small_w = hd[H_SMALL_W];
    const int nl = hd[H_N_LABELS], rgb = hd[H_RGB_DIM];
    named_barrier(bar, 128);   // y of the heads written by other threads
    for (int i = ltid; i < WG_ROWS * small_w; i += 128) {
      const int r = i / small_w;
      const int c = i - r * small_w;
      const size_t R = (size_t)s_row[r];
      const bool ok = s_row[r] >= 0;
      const size_t sr = sr0 + r;
      const float v = head_dy(ok, R, sr, c, nl, rgb);
      const bf16 bv = __float2bfloat16_rn(v);
      s_s[r * s_pitch + c] = bv;
      int co, w, k;
      if (c < hd[H_LBL_COL]) {
        co = hd[H_DEV_SIG_DY]; w = 64; k = c;
      } else if (c < hd[H_RGB_COL]) {
        co = hd[H_DEV_LBL_DY]; w = hd[H_DEV_LBL_DY_W]; k = c - hd[H_LBL_COL];
      } else {
        co = hd[H_DEV_RGB_DY]; w = hd[H_DEV_RGB_DY_W]; k = c - hd[H_RGB_COL];
      }
      dyscr[tiled(co, w, rows_total, sr, k)] = bv;
    }
    for (int c = ltid; c < small_w; c += 128) {
      int dbp;
      if (c < hd[H_LBL_COL]) dbp = hd[H_SIG_DBP] + c;
      else if (c < hd[H_RGB_COL]) dbp = hd[H_LBL_DBP] + c - hd[H_LBL_COL];
      else dbp = hd[H_RGB_DBP] + c - hd[H_RGB_COL];
      float sum = 0.f;
      for (int r = 0; r < WG_ROWS; ++r) {
        if (s_row[r] < 0) continue;
        sum += head_dy(true, (size_t)s_row[r], sr0 + r, c, nl, rgb);
      }
      part[dbp] = sum;
    }
    named_barrier(bar, 128);   // the small buffer is read by every thread
  }

  __device__ __forceinline__ float head_dy(bool ok, size_t R, size_t sr,
                                           int c, int nl, int rgb) const {
    if (!ok) return 0.f;
    if (c < hd[H_LBL_COL]) {           // sigma: one column of 16
      return c == 0 ? gout[R * out_dim + out_dim - 1] : 0.f;
    }
    if (c < hd[H_RGB_COL]) {           // labels
      const int k = c - hd[H_LBL_COL];
      if (k >= nl) return 0.f;
      float v = gout[R * out_dim + k];
      if (hd[H_LABEL_SIG]) {
        const float s = sigmoidf(
            yscr[(size_t)hd[H_DEV_LBL_Y] * rows_total
                 + sr * hd[H_DEV_LBL_Y_W] + k]);
        v = v * s * (1.f - s);
      }
      return v;
    }
    const int k = c - hd[H_RGB_COL];  // rgb
    if (k >= rgb) return 0.f;
    float v = gout[R * out_dim + nl + k];
    if (hd[H_RGB_SIG]) {
      const float s = sigmoidf(
          yscr[(size_t)hd[H_DEV_RGB_Y] * rows_total
               + sr * hd[H_DEV_RGB_Y_W] + k]);
      v = v * s * (1.f - s);
    }
    return v;
  }
};

// (a) forward recompute + backward chain of 128-row tiles
__global__ void __launch_bounds__(THREADS, 1)
bwd_rows_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                const bf16* __restrict__ gf, const float* __restrict__ gout,
                const float* __restrict__ fgeo, const float* __restrict__ pgeo,
                const float* __restrict__ fapp, const float* __restrict__ papp,
                const bf16* __restrict__ wdev,
                const float* __restrict__ biases,
                const int* __restrict__ prog, int n_bias, int n_per_batch,
                int tiles_per_batch, int n_tiles, float* __restrict__ yscr,
                bf16* __restrict__ xscr, bf16* __restrict__ dyscr,
                float* __restrict__ tile_part, float* __restrict__ dpts,
                float* __restrict__ ddirs, float* __restrict__ dgf) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int* hd = prog;
  const Layout L = make_layout(hd, n_bias);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  const int tid = threadIdx.x;
  const int n_steps = hd[H_N_FWD] + hd[H_N_BWD];
  if (tid == 0) {
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer: the weight chunks of every step, for every tile ----
    setmaxnreg_dec<24>();
    if (tid == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int si = 0; si < n_steps; ++si) {
          const int* d = prog + HEAD_INTS + si * STEP_INTS;
          const int np = d[S_NDEV] < PASS ? d[S_NDEV] : PASS;
          const uint32_t bytes = (uint32_t)np * 128;
          const bf16* src = wdev + d[S_DOFF];
          const int n_chunks = d[S_NCHUNK];
          for (int c = 0; c < n_chunks; ++c) {
            mbar_wait(&empty[s], ph ^ 1);
            mbar_arrive_expect_tx(&full[s], bytes);
            bulk_copy_g2s(smem + L.off_w + s * L.stage_bytes,
                          src + (size_t)c * np * 64, bytes, &full[s]);
            if (++s == L.stages) {
              s = 0;
              ph ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumers ----------------------------------------------------------
  setmaxnreg_inc<240>();
  const int cw = tid >> 7;
  RowConsumer C;
  C.hd = hd;
  C.gout = gout;
  float* s_bias = reinterpret_cast<float*>(smem + L.off_bias);
  float* s_tab = reinterpret_cast<float*>(smem + L.off_tab);
  C.s_bias = s_bias;
  C.s_tab = s_tab;
  C.yscr = yscr; C.xscr = xscr; C.dyscr = dyscr;
  C.dpts = dpts; C.ddirs = ddirs; C.dgf = dgf;
  C.rows_total = (size_t)n_tiles * TILE;
  C.hidden = hd[H_HIDDEN];
  C.g = hd[H_G];
  C.l_geo = hd[H_L_GEO];
  C.out_dim = hd[H_OUT_DIM];
  C.full = full; C.empty = empty;
  C.stage0 = smem_u32(smem + L.off_w);
  C.stage_bytes = L.stage_bytes; C.stages = L.stages;
  bf16* s_in = reinterpret_cast<bf16*>(smem + L.off_in)
               + cw * WG_ROWS * L.in_pitch;
  C.s_in = s_in;
  C.in_pitch = L.in_pitch;
  C.s_s = reinterpret_cast<bf16*>(smem + L.off_s) + cw * WG_ROWS * L.s_pitch;
  C.s_pitch = L.s_pitch;
  C.s_part = reinterpret_cast<float*>(smem + L.off_part) + cw * 4 * 3 * 256;
  int* s_row = reinterpret_cast<int*>(smem + L.off_row) + cw * WG_ROWS;
  C.bar = 1 + cw;
  C.ltid = tid & 127;
  C.warp = C.ltid >> 5;
  C.lane = tid & 31;
  C.t = C.lane & 3;
  C.r_lo = C.warp * 16 + (C.lane >> 2);
  C.r_hi = C.r_lo + 8;
  const int in_width = hd[H_IN_WIDTH];
  const int g = hd[H_G];
  const int part_w = hd[H_PART_W];

  // the epilogues' operands in shared memory: every bias once, the FiLM
  // tables of the tile's batch element when it changes
  for (int i = tid; i < n_bias; i += 256) s_bias[i] = biases[i];
  const int l_geo = hd[H_L_GEO], l_app = hd[H_L_APP];
  const int hidden = hd[H_HIDDEN];
  int staged = -1;

  Pipe p = {0, 0u, -1};
  float acc[PASS / 2];
  uint32_t frag[64], fout[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) frag[i] = fout[i] = 0u;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    C.batch = tile / tiles_per_batch;
    const int n0 = (tile - C.batch * tiles_per_batch) * TILE + cw * WG_ROWS;
    const size_t sr0 = (size_t)tile * TILE + cw * WG_ROWS;
    C.part = tile_part + ((size_t)tile * 2 + cw) * part_w;
    if (C.batch != staged) {
      named_barrier(3, 256);   // both warpgroups are done with the tables
      const int per = (l_geo + l_app) * 2 * hidden;
      for (int i = tid; i < per; i += 256) {
        const int c = i % hidden;
        const int r = i / hidden;
        const int which = r & 1, l = r >> 1;
        const float* src = l < l_geo
            ? (which ? pgeo : fgeo) + ((size_t)C.batch * l_geo + l) * hidden
            : (which ? papp : fapp)
                  + ((size_t)C.batch * l_app + l - l_geo) * hidden;
        s_tab[(l * hidden + (c & ~1)) * 2 + which * 2 + (c & 1)] = src[c];
      }
      staged = C.batch;
    }
    named_barrier(3, 256);   // tables visible; the last tile's s_in, s_s free
    if (C.ltid < WG_ROWS) {
      const int n = n0 + C.ltid;
      s_row[C.ltid] = n < n_per_batch ? C.batch * n_per_batch + n : -1;
    }
    named_barrier(C.bar, 128);
    // input tile [points(3) pad | dirs(3) pad | grid feats(g) pad], bf16,
    // and its copies to the x regions of trunk layer 0 and color layer 0
    for (int i = C.ltid; i < WG_ROWS * in_width; i += 128) {
      const int r = i / in_width;
      const int c = i - r * in_width;
      const int R = s_row[r];
      float v = 0.f;
      if (R >= 0) {
        if (c < 3) v = pts[(size_t)R * 3 + c];
        else if (c >= 16 && c < 19) v = dirs[(size_t)R * 3 + (c - 16)];
        else if (c >= 32 && c - 32 < g)
          v = __bfloat162float(gf[(size_t)R * g + (c - 32)]);
      }
      const bf16 bv = __float2bfloat16_rn(v);
      s_in[r * L.in_pitch + c] = bv;
      if (c < 16)
        xscr[tiled(hd[H_DEV_PTS_X], 64, C.rows_total, sr0 + r, c)] = bv;
      else
        xscr[tiled(hd[H_DEV_DG_X], hd[H_DEV_DG_W], C.rows_total, sr0 + r,
                   c - 16)] = bv;
    }
    named_barrier(C.bar, 128);
    C.ok_lo = s_row[C.r_lo] >= 0;
    C.ok_hi = s_row[C.r_hi] >= 0;
    C.in_lo = (size_t)(C.ok_lo ? s_row[C.r_lo] : 0);
    C.in_hi = (size_t)(C.ok_hi ? s_row[C.r_hi] : 0);
    C.sr_lo = sr0 + C.r_lo;
    C.sr_hi = sr0 + C.r_hi;

    for (int si = 0; si < n_steps; ++si) {
      if (si == hd[H_N_FWD]) C.seed(s_row, sr0);
      const int* d = prog + HEAD_INTS + si * STEP_INTS;
      switch (d[S_NDEV]) {
        case 16: C.step<16, 1>(d, acc, frag, fout, p); break;
        case 32: C.step<32, 1>(d, acc, frag, fout, p); break;
        case 64: C.step<64, 1>(d, acc, frag, fout, p); break;
        case 128: C.step<PASS, 128 / PASS>(d, acc, frag, fout, p); break;
        default: C.step<PASS, 256 / PASS>(d, acc, frag, fout, p); break;
      }
    }
  }
}

// (b) dW partials: x^T dy of one 64-column block of a layer's x region over
// one row split; chunk c of the split goes to warpgroup c % 2
template <int N>
__device__ __forceinline__ void dw_chunks(float* acc, uint32_t xs, int cw,
                                          int n_chunks,
                                          uint64_t* full, uint64_t* empty,
                                          int lane) {
  int prev = -1;
  for (int c = cw; c < n_chunks; c += 2) {
    const int s = c % DW_STAGES;
    mbar_wait(&full[s], (uint32_t)((c / DW_STAGES) & 1));
    const uint32_t xa = xs + s * DW_STAGE;
    const uint32_t da = xa + 8192;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Wgmma<N>::template ss<1, 1>(acc, desc_sw128(xa + kk * 2048, 8192, 1024),
                                  desc_sw128(da + kk * 2048, 8192, 1024), 1);
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = s;
  }
  wgmma_wait<0>();
  fence_regs<N / 2>(acc);
  if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
}

__global__ void __launch_bounds__(THREADS, 1)
dw_kernel(const bf16* __restrict__ xscr, const bf16* __restrict__ dyscr,
          const int* __restrict__ items, int rows_total, int split_rows,
          int dw_total, float* __restrict__ dw_part) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + DW_STAGES;
  unsigned char* stages = smem + 1024;
  const int* it = items + blockIdx.x * DW_INTS;
  const int x_co = it[D_XCO], x_w = it[D_XW], x_col = it[D_XCOL];
  const int dy_co = it[D_DYCO], dy_w = it[D_DYW];
  const int r0 = blockIdx.y * split_rows;
  const int r1 = r0 + split_rows < rows_total ? r0 + split_rows : rows_total;
  const int n_chunks = (r1 - r0) >> 6;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);   // the warps of the chunk's warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();
  const size_t rt = (size_t)rows_total;
  if (tid >= 256) {
    if (tid == 256) {
      const uint32_t dy_bytes = (uint32_t)dy_w * 128;
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c % DW_STAGES;
        mbar_wait(&empty[s], (uint32_t)(((c / DW_STAGES) & 1) ^ 1));
        mbar_arrive_expect_tx(&full[s], 8192 + dy_bytes);
        const size_t blk = (size_t)(r0 >> 6) + c;
        bulk_copy_g2s(stages + s * DW_STAGE,
                      xscr + (size_t)x_co * rt + blk * 64 * x_w
                          + (size_t)(x_col >> 6) * 4096,
                      8192, &full[s]);
        bulk_copy_g2s(stages + s * DW_STAGE + 8192,
                      dyscr + (size_t)dy_co * rt + blk * 64 * dy_w, dy_bytes,
                      &full[s]);
      }
    }
    return;
  }
  const int cw = tid >> 7;
  const int ltid = tid & 127;
  const int lane = tid & 31;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  fence_regs<128>(acc);
  const uint32_t xs = smem_u32(stages);
  switch (dy_w) {
    case 64: dw_chunks<64>(acc, xs, cw, n_chunks, full, empty, lane); break;
    case 128: dw_chunks<128>(acc, xs, cw, n_chunks, full, empty, lane); break;
    default: dw_chunks<256>(acc, xs, cw, n_chunks, full, empty, lane); break;
  }
  // the two warpgroups' partials, added in a fixed order
  named_barrier(1, 256);   // every chunk consumed: the stages are free
  float* buf = reinterpret_cast<float*>(stages);
  const int nr = dy_w / 2;
  if (cw == 1) {
    for (int i = 0; i < 128; ++i)
      if (i < nr) buf[i * 128 + ltid] = acc[i];
  }
  named_barrier(1, 256);
  if (cw == 1) return;
  const int warp = ltid >> 5, g8 = lane >> 2, t = lane & 3;
  const int rows = it[D_ROWS], n_pad = it[D_NPAD];
  float* out = dw_part + (size_t)blockIdx.y * dw_total + it[D_DWOFF]
               + (size_t)it[D_WROW] * n_pad;
#pragma unroll
  for (int i = 0; i < 128; ++i) {
    if (i < nr) {
      const int m = warp * 16 + g8 + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * t + (i & 1);
      if (m < rows && col < n_pad)
        out[(size_t)m * n_pad + col] = acc[i] + buf[i * 128 + ltid];
    }
  }
}

// (c) out[grp, j] = sum over t < per_group of in[(grp*per_group + t)*stride
//     + col0 + j], t in order
__global__ void reduce_kernel(const float* __restrict__ in, int per_group,
                              int stride, int col0, int width,
                              float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int grp = blockIdx.y;
  if (j >= width) return;
  const float* p = in + (size_t)grp * per_group * stride + col0 + j;
  float sum = 0.f;
  for (int t = 0; t < per_group; ++t) sum += p[(size_t)t * stride];
  out[(size_t)grp * width + j] = sum;
}

int g_num_sms = 0;

}  // namespace

extern "C" {

// Launches (a), (b) and the three reductions on `stream`; returns
// cudaGetLastError() after each (0 = all launched). The header values the
// launch needs on the host come in `head_host` (the first HEAD_INTS ints
// of the program).
int film_mlp_bwd_launch(const void* pts, const void* dirs, const void* gf,
                        const void* gout, const void* fgeo, const void* pgeo,
                        const void* fapp, const void* papp,
                        const void* wdev, const void* biases,
                        const void* program, int n_bias, int batch,
                        int n_per_batch,
                        int n_dw_items, int n_splits, const void* dw_items,
                        void* yscr, void* xscr, void* dyscr, void* tile_part,
                        void* dw_part, void* dw, void* db, int dw_total,
                        int split_rows, int film_w, void* film, void* dpts,
                        void* ddirs, void* dgf, const void* head_host,
                        void* stream) {
  const int* hd = (const int*)head_host;
  cudaStream_t s = (cudaStream_t)stream;
  const Layout L = make_layout(hd, n_bias);
  if (L.stages < 2) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L.total + 1024);
  if (err != cudaSuccess) return (int)err;
  const int dw_smem = 1024 + DW_STAGES * DW_STAGE + 1024;
  err = cudaFuncSetAttribute(
      dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem);
  if (err != cudaSuccess) return (int)err;
  if (g_num_sms == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&g_num_sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int tpb = (n_per_batch + TILE - 1) / TILE;
  const int n_tiles = batch * tpb;
  const int blocks = n_tiles < g_num_sms ? n_tiles : g_num_sms;
  bwd_rows_kernel<<<blocks, THREADS, L.total + 1024, s>>>(
      (const float*)pts, (const float*)dirs, (const bf16*)gf,
      (const float*)gout, (const float*)fgeo, (const float*)pgeo,
      (const float*)fapp, (const float*)papp, (const bf16*)wdev,
      (const float*)biases, (const int*)program, n_bias, n_per_batch, tpb,
      n_tiles,
      (float*)yscr, (bf16*)xscr, (bf16*)dyscr, (float*)tile_part,
      (float*)dpts, (float*)ddirs, (float*)dgf);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dw_kernel<<<dim3(n_dw_items, n_splits), THREADS, dw_smem, s>>>(
      (const bf16*)xscr, (const bf16*)dyscr, (const int*)dw_items,
      n_tiles * TILE, split_rows, dw_total, (float*)dw_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int part_w = hd[H_PART_W], db_w = hd[H_DB_W];
  reduce_kernel<<<dim3((dw_total + 255) / 256, 1), 256, 0, s>>>(
      (const float*)dw_part, n_splits, dw_total, 0, dw_total, (float*)dw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // per-(tile, warpgroup) partials: two per tile
  reduce_kernel<<<dim3((db_w + 255) / 256, 1), 256, 0, s>>>(
      (const float*)tile_part, 2 * n_tiles, part_w, 0, db_w, (float*)db);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_kernel<<<dim3((film_w + 255) / 256, batch), 256, 0, s>>>(
      (const float*)tile_part, 2 * tpb, part_w, db_w, film_w, (float*)film);
  return (int)cudaGetLastError();
}

const char* film_mlp_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
