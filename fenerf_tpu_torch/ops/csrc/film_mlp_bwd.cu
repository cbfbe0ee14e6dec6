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
// The per-layer y of a 64-row tile (720 KB) does not fit shared memory
// either. So the design pays device-memory traffic instead (~25 KB per
// point written and read, ~1.3 ms of HBM time at the G-phase shape):
//
//   (a) bwd_rows_kernel: one CTA of 8 warps per 64-row tile, the tile inside
//       one batch element (so film gradients are per tile). It runs the
//       layer program of ops/film_mlp_grad.py::pack_bwd: forward recompute
//       steps, the head seeds from g_out, backward steps. Activations and
//       bf16 dy live in shared memory; each linear's bf16 input x, bf16 dy
//       and each FiLM layer's f32 y go to per-row scratch; db, dfreq and
//       dphase are summed per tile in a fixed order into per-tile partials;
//       dpoints / ddirs / dgf are written directly.
//   (b) dw_kernel: dW = x^T dy of every linear over row splits of 4096 rows,
//       one 64x64 output tile per CTA; x is loaded as a column-major wmma
//       fragment, so the transpose is free. f32 partials per split.
//   (c) reduce_kernel: sums per-split / per-tile partials in a fixed order.
// No atomics: the result is the same from run to run.
//
// Products use nvcuda::wmma bf16 16x16x16 with f32 accumulators, weights
// staged in 32-row chunks with cp.async as in film_mlp.cu; the row kernel
// fits two CTAs per SM. wgmma, TMA and keeping y on chip are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KC = 32;       // weight rows staged per step (row kernel)
constexpr int DW_KC = 64;    // rows per chunk of the dW kernel
constexpr int MAX_FRAGS = 8;
constexpr int STEP_INTS = 32;
constexpr int HEAD_INTS = 48;
constexpr int DWT = 64;   // dW output tile
constexpr int DWP = DWT + 8;

enum { BUF_IN = 0, BUF_A = 1, BUF_B = 2, BUF_S = 3 };
enum { E_FILM_FWD = 0, E_LIN_FWD, E_PRE, E_FILM_BWD, E_LIN_BWD, E_OUT };
// header fields (ops/film_mlp_grad.py::_head_names)
enum {
  H_N_FWD = 0, H_N_BWD, H_HIDDEN, H_G, H_L_GEO, H_L_APP, H_IN_WIDTH,
  H_MAX_N_PAD, H_Y_W, H_X_W, H_DY_W, H_PART_W, H_PHASE_OFF, H_XG_PTS,
  H_XG_DIRS, H_N_LABELS, H_LABEL_SIG, H_LBL_Y, H_LBL_DYG, H_LBL_DBP,
  H_LBL_COL, H_RGB_DIM, H_RGB_SIG, H_RGB_Y, H_RGB_DYG, H_RGB_DBP, H_RGB_COL,
  H_SIG_DYG, H_SIG_DBP, H_SMALL_W, H_OUT_DIM, H_DB_W
};

struct Layout {
  int in_pitch, h_pitch, s_pitch, off_in, off_a, off_b, off_s, off_w,
      off_scr, off_part, off_row, total;
};

__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

__host__ __device__ inline Layout make_layout(int in_width, int hidden,
                                              int small_w, int max_n_pad) {
  Layout L;
  L.in_pitch = in_width + 8;
  L.h_pitch = hidden + 8;
  L.s_pitch = small_w + 8;
  int off = 0;
  L.off_in = off;
  off = align128(off + TILE * L.in_pitch * 2);
  L.off_a = off;
  off = align128(off + TILE * L.h_pitch * 2);
  L.off_b = off;
  off = align128(off + TILE * L.h_pitch * 2);
  L.off_s = off;
  off = align128(off + TILE * L.s_pitch * 2);
  // the weight stage; the column-sum partials of an epilogue
  // ([4 row blocks][3 sums][256 columns] f32) reuse it between the K loop
  // and the next step's staging
  L.off_w = off;
  L.off_part = off;
  const int w_bytes = KC * (max_n_pad + 8) * 2;
  const int part_bytes = 4 * 3 * 256 * 4;
  off = align128(off + (w_bytes > part_bytes ? w_bytes : part_bytes));
  L.off_scr = off;
  off = align128(off + WARPS * 256 * 4);
  L.off_row = off;   // input row of each tile row, -1 past the end
  off = align128(off + TILE * 4);
  L.total = off;
  return L;
}

// fenerf_tpu/ops/fast_math.py: _poly_sin(_reduce(x)), degree 9, the
// reduction rounding half to even and free of FMA contraction.
__device__ __forceinline__ float fast_sin(float x) {
  const float kTwoPi = 6.283185307179586f;
  const float kInvTwoPi = 0.15915494309189535f;
  const float r = __fsub_rn(x, __fmul_rn(kTwoPi, rintf(__fmul_rn(x, kInvTwoPi))));
  const float r2 = r * r;
  float acc = 2.1732100680830095e-06f;
  acc = acc * r2 + -0.00019316182196017474f;
  acc = acc * r2 + 0.008312382933816725f;
  acc = acc * r2 + -0.16663258204297426f;
  acc = acc * r2 + 0.999984586774494f;
  return acc * r;
}

// fenerf_tpu/ops/film_mlp_grad.py::_fcos: the sine of v + pi/2
__device__ __forceinline__ float fast_cos(float v) {
  return fast_sin(__fadd_rn(v, 1.5707963267948966f));
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void store8_bf16(bf16* dst, const float* v) {
  __align__(16) bf16 packed[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) packed[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(packed);
}

__device__ __forceinline__ void load8_f32(const float* src, float* v) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8_f32(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// sum over the 16 rows of a warp's row block: lanes hold row lane >> 1,
// columns (lane & 1) * 8 + i; xor over the row bits, a fixed order
__device__ __forceinline__ float rowsum16(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 16);
  return x;
}

// (a) forward recompute + backward chain of one 64-row tile; two CTAs per
// SM (<= 128 registers, ~109 KB of shared memory for the flagship)
__global__ void __launch_bounds__(THREADS, 2)
bwd_rows_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                const bf16* __restrict__ gf, const float* __restrict__ gout,
                const float* __restrict__ fgeo, const float* __restrict__ pgeo,
                const float* __restrict__ fapp, const float* __restrict__ papp,
                const bf16* __restrict__ weights,
                const float* __restrict__ biases,
                const int* __restrict__ prog, int n_per_batch,
                int tiles_per_batch, float* __restrict__ yscr,
                bf16* __restrict__ xscr, bf16* __restrict__ dyscr,
                float* __restrict__ tile_part, float* __restrict__ dpts,
                float* __restrict__ ddirs, float* __restrict__ dgf) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int* hd = prog;
  const int hidden = hd[H_HIDDEN], g = hd[H_G];
  const int l_geo = hd[H_L_GEO], l_app = hd[H_L_APP];
  const int in_width = hd[H_IN_WIDTH];
  const int y_w = hd[H_Y_W], x_w = hd[H_X_W], dy_w = hd[H_DY_W];
  const int part_w = hd[H_PART_W], out_dim = hd[H_OUT_DIM];
  const Layout L = make_layout(in_width, hidden, hd[H_SMALL_W],
                               hd[H_MAX_N_PAD]);
  bf16* s_in = reinterpret_cast<bf16*>(smem + L.off_in);
  bf16* s_a = reinterpret_cast<bf16*>(smem + L.off_a);
  bf16* s_b = reinterpret_cast<bf16*>(smem + L.off_b);
  bf16* s_s = reinterpret_cast<bf16*>(smem + L.off_s);
  bf16* s_w = reinterpret_cast<bf16*>(smem + L.off_w);
  float* s_part = reinterpret_cast<float*>(smem + L.off_part);
  int* s_row = reinterpret_cast<int*>(smem + L.off_row);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* s_scr = reinterpret_cast<float*>(smem + L.off_scr) + warp * 256;

  const int tile = blockIdx.x;
  const int batch = tile / tiles_per_batch;
  const int n0 = (tile - batch * tiles_per_batch) * TILE;
  const size_t srow0 = (size_t)tile * TILE;    // scratch row of tile row 0
  float* part = tile_part + (size_t)tile * part_w;
  if (tid < TILE) {
    const int n = n0 + tid;
    s_row[tid] = n < n_per_batch ? batch * n_per_batch + n : -1;
  }
  __syncthreads();

  // input tile [points(3) pad | dirs(3) pad | grid feats(g) pad], bf16,
  // and its copies to the x scratch of trunk layer 0 and color layer 0
  for (int i = tid; i < TILE * in_width; i += THREADS) {
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
    bf16* xrow = xscr + (srow0 + r) * x_w;
    if (c < 16) xrow[hd[H_XG_PTS] + c] = bv;
    else xrow[hd[H_XG_DIRS] + c - 16] = bv;
  }
  __syncthreads();

  const int rb = warp & 3;
  const int cb0 = warp >> 2;
  const int n_steps = hd[H_N_FWD] + hd[H_N_BWD];

  for (int si = 0; si < n_steps; ++si) {
    if (si == hd[H_N_FWD]) {
      // seeds of the backward: dy of the sigma, label and rgb heads from
      // g_out (sigmoid derivatives on the stored pre-activations), into
      // the small buffer and the dy scratch; pads and rows past the end 0
      const int small_w = hd[H_SMALL_W];
      const int nl = hd[H_N_LABELS], rgb = hd[H_RGB_DIM];
      for (int i = tid; i < TILE * small_w; i += THREADS) {
        const int r = i / small_w;
        const int c = i - r * small_w;
        const int R = s_row[r];
        const size_t sr = srow0 + r;
        float v = 0.f;
        int dyg;
        if (c < hd[H_LBL_COL]) {          // sigma: one column of 16
          dyg = hd[H_SIG_DYG] + c;
          if (R >= 0 && c == 0) v = gout[(size_t)R * out_dim + out_dim - 1];
        } else if (c < hd[H_RGB_COL]) {   // labels
          const int k = c - hd[H_LBL_COL];
          dyg = hd[H_LBL_DYG] + k;
          if (R >= 0 && k < nl) {
            v = gout[(size_t)R * out_dim + k];
            if (hd[H_LABEL_SIG]) {
              const float s = sigmoidf(yscr[sr * y_w + hd[H_LBL_Y] + k]);
              v = v * s * (1.f - s);
            }
          }
        } else {                          // rgb
          const int k = c - hd[H_RGB_COL];
          dyg = hd[H_RGB_DYG] + k;
          if (R >= 0 && k < rgb) {
            v = gout[(size_t)R * out_dim + nl + k];
            if (hd[H_RGB_SIG]) {
              const float s = sigmoidf(yscr[sr * y_w + hd[H_RGB_Y] + k]);
              v = v * s * (1.f - s);
            }
          }
        }
        const bf16 bv = __float2bfloat16_rn(v);
        s_s[r * L.s_pitch + c] = bv;
        dyscr[sr * dy_w + dyg] = bv;
      }
      // db of the heads: one thread per column, rows in order, f32 dy
      for (int c = tid; c < small_w; c += THREADS) {
        int dbp;
        if (c < hd[H_LBL_COL]) dbp = hd[H_SIG_DBP] + c;
        else if (c < hd[H_RGB_COL]) dbp = hd[H_LBL_DBP] + c - hd[H_LBL_COL];
        else dbp = hd[H_RGB_DBP] + c - hd[H_RGB_COL];
        float sum = 0.f;
        for (int r = 0; r < TILE; ++r) {
          const int R = s_row[r];
          if (R < 0) continue;
          const size_t sr = srow0 + r;
          float v = 0.f;
          if (c < hd[H_LBL_COL]) {
            if (c == 0) v = gout[(size_t)R * out_dim + out_dim - 1];
          } else if (c < hd[H_RGB_COL]) {
            const int k = c - hd[H_LBL_COL];
            if (k < nl) {
              v = gout[(size_t)R * out_dim + k];
              if (hd[H_LABEL_SIG]) {
                const float s = sigmoidf(yscr[sr * y_w + hd[H_LBL_Y] + k]);
                v = v * s * (1.f - s);
              }
            }
          } else {
            const int k = c - hd[H_RGB_COL];
            if (k < rgb) {
              v = gout[(size_t)R * out_dim + nl + k];
              if (hd[H_RGB_SIG]) {
                const float s = sigmoidf(yscr[sr * y_w + hd[H_RGB_Y] + k]);
                v = v * s * (1.f - s);
              }
            }
          }
          sum += v;
        }
        part[dbp] = sum;
      }
      __syncthreads();
    }

    const int* d = prog + HEAD_INTS + si * STEP_INTS;
    const int n_seg = d[0];
    const int n_pad = d[10];
    const bf16* W = weights + d[11];
    const int kind = d[13];
    const int k_total = d[25];
    const int n_blk = n_pad >> 4;
    const int wp = n_pad + 8;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAX_FRAGS];
#pragma unroll
    for (int j = 0; j < MAX_FRAGS; ++j) wmma::fill_fragment(acc[j], 0.f);

    for (int k0 = 0; k0 < k_total; k0 += KC) {
      const int kc = min(KC, k_total - k0);
      const int vec_per_row = n_pad >> 3;
      for (int v = tid; v < kc * vec_per_row; v += THREADS) {
        const int r = v / vec_per_row;
        const int cv = v - r * vec_per_row;
        cp_async16(s_w + r * wp + cv * 8,
                   W + (size_t)(k0 + r) * n_pad + cv * 8);
      }
      cp_async_wait_all();
      __syncthreads();
      for (int kk = 0; kk < kc; kk += 16) {
        const int k = k0 + kk;
        int s = 0, start = 0;
        while (s < n_seg - 1 && k >= start + d[3 + 3 * s]) {
          start += d[3 + 3 * s];
          ++s;
        }
        const int src = d[1 + 3 * s];
        const int col = d[2 + 3 * s] + (k - start);
        const bf16* abase = src == BUF_IN ? s_in
                            : src == BUF_A ? s_a
                            : src == BUF_B ? s_b : s_s;
        const int apitch = src == BUF_IN ? L.in_pitch
                           : src == BUF_S ? L.s_pitch : L.h_pitch;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, abase + rb * 16 * apitch + col, apitch);
#pragma unroll
        for (int j = 0; j < MAX_FRAGS; ++j) {
          const int cb = cb0 + 2 * j;
          if (cb < n_blk) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
            wmma::load_matrix_sync(b, s_w + kk * wp + cb * 16, wp);
            wmma::mma_sync(acc[j], a, b, acc[j]);
          }
        }
      }
      __syncthreads();  // every read of this step's sources is done
    }

    // epilogue: this lane finishes 8 columns of one row of each fragment
    const int b_off = d[12];
    bf16* dst = d[14] == BUF_A ? s_a : s_b;
    const int film = d[16], chunk = d[17];
    const int y_off = d[19], xg_off = d[20], dyg_off = d[21];
    const int dbp_off = d[22], fp_off = d[23], target = d[24];
    const float* ftab = film == 0 ? fgeo : fapp;
    const float* ptab = film == 0 ? pgeo : papp;
    const int n_film = film == 0 ? l_geo : l_app;
    const int er = lane >> 1;
    const int ec = (lane & 1) * 8;
    const int tr = rb * 16 + er;
    const int R = s_row[tr];
    const size_t sr = srow0 + tr;
#pragma unroll
    for (int j = 0; j < MAX_FRAGS; ++j) {
      const int cb = cb0 + 2 * j;
      if (cb < n_blk) {
        wmma::store_matrix_sync(s_scr, acc[j], 16, wmma::mem_row_major);
        __syncwarp();
        const int gc = cb * 16 + ec;
        float v[8];
        load8_f32(s_scr + er * 16 + ec, v);
        if (kind == E_FILM_FWD || kind == E_LIN_FWD || kind == E_PRE) {
          float bb[8];
          load8_f32(biases + b_off + gc, bb);
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = R >= 0 ? v[i] + bb[i] : 0.f;
          if (kind == E_FILM_FWD || kind == E_PRE)
            store8_f32(yscr + sr * y_w + y_off + gc, v);
          if (kind == E_FILM_FWD && R >= 0) {
            const size_t fi = ((size_t)batch * n_film + chunk) * hidden + gc;
            float f[8], p[8];
            load8_f32(ftab + fi, f);
            load8_f32(ptab + fi, p);
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = fast_sin(f[i] * v[i] + p[i]);
          }
          if (kind != E_PRE) {
            store8_bf16(dst + tr * L.h_pitch + gc, v);
            store8_bf16(xscr + sr * x_w + xg_off + gc, v);
          }
        } else if (kind == E_FILM_BWD || kind == E_LIN_BWD) {
          float sy[8], ss[8];
          if (kind == E_FILM_BWD) {
            const size_t fi = ((size_t)batch * n_film + chunk) * hidden + gc;
            float f[8], p[8], y[8];
            load8_f32(ftab + fi, f);
            load8_f32(ptab + fi, p);
            load8_f32(yscr + sr * y_w + y_off + gc, y);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float s = R >= 0 ? fast_cos(f[i] * y[i] + p[i]) * v[i]
                                     : 0.f;
              sy[i] = s * y[i];
              ss[i] = s;
              v[i] = s * f[i];
            }
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              if (R < 0) v[i] = 0.f;
              sy[i] = ss[i] = 0.f;
            }
          }
          store8_bf16(dst + tr * L.h_pitch + gc, v);
          store8_bf16(dyscr + sr * dy_w + dyg_off + gc, v);
          // column sums over this warp's 16 rows, then per row block
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float a = rowsum16(sy[i]);
            const float b = rowsum16(ss[i]);
            const float c = rowsum16(v[i]);
            if (er == 0) {
              s_part[(rb * 3 + 0) * 256 + gc + i] = a;
              s_part[(rb * 3 + 1) * 256 + gc + i] = b;
              s_part[(rb * 3 + 2) * 256 + gc + i] = c;
            }
          }
        } else if (R >= 0) {  // E_OUT: dpoints, or ddirs and dgf
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int c = gc + i;
            if (target == 0) {
              if (c < 3) dpts[(size_t)R * 3 + c] = v[i];
            } else if (c < 3) {
              ddirs[(size_t)R * 3 + c] = v[i];
            } else if (c >= 16 && c - 16 < g) {
              dgf[(size_t)R * g + (c - 16)] = v[i];
            }
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();
    if (kind == E_FILM_BWD || kind == E_LIN_BWD) {
      // per-tile partials: the four row blocks in order
      for (int c = tid; c < n_pad; c += THREADS) {
        float sum[3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          sum[k] = ((s_part[(0 * 3 + k) * 256 + c]
                     + s_part[(1 * 3 + k) * 256 + c])
                    + s_part[(2 * 3 + k) * 256 + c])
                   + s_part[(3 * 3 + k) * 256 + c];
        part[dbp_off + c] = sum[2];
        if (kind == E_FILM_BWD) {
          part[fp_off + c] = sum[0];
          part[fp_off + hd[H_PHASE_OFF] + c] = sum[1];
        }
      }
      __syncthreads();  // s_part is the next step's weight stage
    }
  }
}

// (b) dW partials: one 64x64 tile of one layer's x^T dy over one row split
__global__ void __launch_bounds__(THREADS)
dw_kernel(const bf16* __restrict__ xscr, const bf16* __restrict__ dyscr,
          const int* __restrict__ tiles, int x_w, int dy_w, int rows,
          int split_rows, int dw_total, float* __restrict__ dw_part) {
  __shared__ __align__(128) bf16 s_x[DW_KC * DWP];
  __shared__ __align__(128) bf16 s_dy[DW_KC * DWP];
  const int* t = tiles + blockIdx.x * 8;
  const int xg = t[0], k = t[1], dyg = t[2], n = t[3], dw_off = t[4];
  const int m0 = t[5], n0 = t[6];
  const int mw = min(DWT, k - m0), nw = min(DWT, n - n0);
  const int r_begin = blockIdx.y * split_rows;
  const int r_end = min(rows, r_begin + split_rows);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn0 = (warp >> 2) * 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  const int xv = mw >> 3, dv = nw >> 3;   // 16-byte vectors per row
  for (int r0 = r_begin; r0 < r_end; r0 += DW_KC) {
    for (int i = tid; i < DW_KC * (xv + dv); i += THREADS) {
      const int r = i / (xv + dv);
      const int c = i - r * (xv + dv);
      const size_t R = (size_t)(r0 + r);
      if (c < xv)
        cp_async16(s_x + r * DWP + c * 8, xscr + R * x_w + xg + m0 + c * 8);
      else
        cp_async16(s_dy + r * DWP + (c - xv) * 8,
                   dyscr + R * dy_w + dyg + n0 + (c - xv) * 8);
    }
    cp_async_wait_all();
    __syncthreads();
    if (wm * 16 < mw) {
#pragma unroll
      for (int kk = 0; kk < DW_KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::load_matrix_sync(a, s_x + kk * DWP + wm * 16, DWP);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if ((wn0 + j) * 16 < nw) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
            wmma::load_matrix_sync(b, s_dy + kk * DWP + (wn0 + j) * 16, DWP);
            wmma::mma_sync(acc[j], a, b, acc[j]);
          }
        }
      }
    }
    __syncthreads();
  }
  if (wm * 16 < mw) {
    float* out = dw_part + (size_t)blockIdx.y * dw_total + dw_off;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if ((wn0 + j) * 16 < nw)
        wmma::store_matrix_sync(
            out + (size_t)(m0 + wm * 16) * n + n0 + (wn0 + j) * 16, acc[j], n,
            wmma::mem_row_major);
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

}  // namespace

extern "C" {

// Launches (a), (b) and the three reductions on `stream`; returns
// cudaGetLastError() after each (0 = all launched). The header values the
// launch needs on the host come in `head_host` (the first HEAD_INTS ints
// of the program).
int film_mlp_bwd_launch(const void* pts, const void* dirs, const void* gf,
                        const void* gout, const void* fgeo, const void* pgeo,
                        const void* fapp, const void* papp,
                        const void* weights, const void* biases,
                        const void* program, int batch, int n_per_batch,
                        int n_dw_tiles, int n_splits, const void* dw_tiles,
                        void* yscr, void* xscr, void* dyscr, void* tile_part,
                        void* dw_part, void* dw, void* db, int dw_total,
                        int split_rows, int film_w, void* film, void* dpts,
                        void* ddirs, void* dgf, const void* head_host,
                        void* stream) {
  const int* hd = (const int*)head_host;
  cudaStream_t s = (cudaStream_t)stream;
  const Layout L = make_layout(hd[H_IN_WIDTH], hd[H_HIDDEN], hd[H_SMALL_W],
                               hd[H_MAX_N_PAD]);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return (int)err;
  const int tpb = (n_per_batch + TILE - 1) / TILE;
  const int n_tiles = batch * tpb;
  bwd_rows_kernel<<<n_tiles, THREADS, L.total, s>>>(
      (const float*)pts, (const float*)dirs, (const bf16*)gf,
      (const float*)gout, (const float*)fgeo, (const float*)pgeo,
      (const float*)fapp, (const float*)papp, (const bf16*)weights,
      (const float*)biases, (const int*)program, n_per_batch, tpb,
      (float*)yscr, (bf16*)xscr, (bf16*)dyscr, (float*)tile_part,
      (float*)dpts, (float*)ddirs, (float*)dgf);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dw_kernel<<<dim3(n_dw_tiles, n_splits), THREADS, 0, s>>>(
      (const bf16*)xscr, (const bf16*)dyscr, (const int*)dw_tiles,
      hd[H_X_W], hd[H_DY_W], n_tiles * TILE, split_rows, dw_total,
      (float*)dw_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int part_w = hd[H_PART_W], db_w = hd[H_DB_W];
  reduce_kernel<<<dim3((dw_total + 255) / 256, 1), 256, 0, s>>>(
      (const float*)dw_part, n_splits, dw_total, 0, dw_total, (float*)dw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_kernel<<<dim3((db_w + 255) / 256, 1), 256, 0, s>>>(
      (const float*)tile_part, n_tiles, part_w, 0, db_w, (float*)db);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_kernel<<<dim3((film_w + 255) / 256, batch), 256, 0, s>>>(
      (const float*)tile_part, tpb, part_w, db_w, film_w, (float*)film);
  return (int)cudaGetLastError();
}

const char* film_mlp_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
