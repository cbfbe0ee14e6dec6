// Fused FiLM-SIREN field forward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fenerf_tpu/ops/film_mlp.py::film_mlp
// (pallas_call at film_mlp.py:295). Per point: 8 trunk FiLM layers
// sin(f * (x W + b) + p), the packed [sigma | folded label] head, 3 color
// FiLM layers over [ray_dir | grid feats | x] and the rgb head, every matmul
// on bf16 operands with f32 accumulation, bias / FiLM / sine in f32.
//
// What bounds it on the card: the flagship field is ~1.35 MFLOP per point
// (eleven 256-wide products) against ~60 bytes of device-memory traffic per
// point, so it is far above the H100's ~295 FLOP/byte ridge: tensor-core
// throughput and the on-chip traffic that feeds it bound it, not HBM.
// The 1.34 MB of bf16 weights do not fit in shared memory.
//
// Design (the building blocks are in hopper.cuh):
//   * one persistent CTA per SM walks 128-row tiles; it has two consumer
//     warpgroups, each owning 64 rows of the tile, and a producer
//     warpgroup. A row's batch element is
//     row / n_per_batch, so tiles may straddle batch elements;
//   * weights: pack() writes every layer as 64-row K chunks, each already
//     in wgmma's 128-byte-swizzled K-major B layout and contiguous, so one
//     1-D bulk copy moves one chunk onto an mbarrier. A ring of up to eight
//     16 KB stages keeps the next chunks in flight while the consumers
//     compute; each stage feeds both warpgroups (128 rows), halving the L2
//     weight traffic per point of a 64-row tile. The producer walks the
//     same chunk sequence for every tile;
//   * products: wgmma m64nNk16 with A from registers. A layer's 64 x N
//     output stays in the warpgroup's accumulators; the epilogue (bias,
//     FiLM with f and p of the row's batch element, fast_sin, the bf16
//     rounding) runs there and turns it into the next layer's A fragments
//     in registers, so trunk activations never go to shared memory. The
//     epilogue is written without branches per element (the last tile's
//     masked columns and rows by selects, every other tile unmasked): a
//     branch per element costs the compiler the interleaving that hides
//     the sine's latency at eight warps per SM. The
//     input tile [points | dirs | grid feats] is read from shared memory
//     into A fragments. Layer widths are padded up to 16/32/64/128/256
//     (zero weight columns); the label-FiLM variants, whose label branch
//     overwrites the registers while the trunk output is still needed,
//     stash it in shared memory once per tile;
//   * registers: a layer of 256 columns runs as two passes of 128 over
//     the whole K (the weight chunks are written pass-major), so a
//     consumer holds a 64 x 128 f32 accumulator (64 registers), the layer's
//     A fragments (64) and the first pass's output fragments (32);
//     setmaxnreg gives the consumers 240 registers and the producer
//     warpgroup (one thread issues copies) 24.
//
// The layer program (LAYER_INTS ints per layer) is built by
// fenerf_tpu_torch/ops/film_mlp.py::pack, which also holds the plain torch
// version of this kernel (film_mlp_reference).

#include "hopper.cuh"

#include <stddef.h>

using namespace hopper;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 128;        // rows per tile
constexpr int WG_ROWS = 64;      // rows per consumer warpgroup
constexpr int THREADS = 384;     // producer warpgroup + 2 consumers
constexpr int PASS = 128;        // columns per pass (ops/film_mlp.py::PASS)
constexpr int MAX_STAGES = 8 * 128 / PASS;   // 128 KB of weight chunks
constexpr int LAYER_INTS = 32;
constexpr int MAX_SMEM = 232448 - 1024;   // less the alignment slack

enum { BUF_IN = 0, BUF_A = 1, BUF_B = 2 };
enum { FILM = 0, LIN_BUF = 1, LIN_OUT = 2 };
// layer program fields (ops/film_mlp.py::pack)
enum {
  P_NSEG = 0, P_NPAD = 10, P_WOFF, P_BOFF, P_KIND, P_DST, P_FILM, P_CHUNK,
  P_NVALID, P_SPLIT, P_OUT0, P_SIG0, P_OUT1, P_SIG1, P_KTOTAL, P_NDEV,
  P_DOFF, P_NCHUNK, P_STASH
};

struct Layout {
  int stages, stage_bytes, off_w, in_pitch, off_in, off_row, h_pitch,
      off_stash, off_bias, off_tab, total;
};

__host__ __device__ inline int align_up(int x, int a) {
  return (x + a - 1) / a * a;
}

// [mbarriers | weight stages (1024-aligned) | input tiles | row batch ids |
//  register stash | biases | FiLM tables of two batch elements], per
// consumer warpgroup where it is per row
__host__ __device__ inline Layout make_layout(int in_width, int hidden,
                                              int max_n_dev, int stash,
                                              int n_bias, int n_film) {
  Layout L;
  L.stage_bytes = (max_n_dev < PASS ? max_n_dev : PASS) * 128;
  L.in_pitch = in_width + 8;
  L.h_pitch = hidden + 8;
  const int in_bytes = align_up(2 * WG_ROWS * L.in_pitch * 2, 128);
  const int row_bytes = 2 * WG_ROWS * 4;
  const int stash_bytes = stash ? 2 * WG_ROWS * L.h_pitch * 2 : 0;
  const int bias_bytes = align_up(n_bias * 4, 128);
  const int tab_bytes = 2 * n_film * 2 * hidden * 4;
  const int rest = in_bytes + row_bytes + stash_bytes + bias_bytes
                   + tab_bytes;
  L.off_w = 1024;
  int st = (MAX_SMEM - 1024 - rest) / L.stage_bytes;
  L.stages = st < MAX_STAGES ? st : MAX_STAGES;
  L.off_in = L.off_w + L.stages * L.stage_bytes;
  L.off_row = L.off_in + in_bytes;
  L.off_stash = L.off_row + row_bytes;
  L.off_bias = L.off_stash + stash_bytes;
  L.off_tab = L.off_bias + bias_bytes;
  L.total = L.off_tab + tab_bytes;
  return L;
}

struct Pipe {
  int s;         // stage of the next chunk
  uint32_t ph;   // its phase parity
  int prev;      // stage whose products may still be in flight, or -1
};

struct Consumer {
  // kernel arguments
  const float* fgeo;
  const float* pgeo;
  const float* fapp;
  const float* papp;
  float* out;
  int hidden, l_geo, l_app, out_dim;
  // shared memory
  uint64_t* full;
  uint64_t* empty;
  uint32_t stage0;   // shared address of stage 0
  int stage_bytes, stages;
  const bf16* s_in;
  int in_pitch;
  bf16* s_stash;
  int h_pitch;
  // this thread
  int lane, t, r_lo, r_hi;  // rows r_lo, r_hi of the warpgroup's 64
  int eb_lo, eb_hi;         // their batch elements, -1 past the end
  int slot_lo, slot_hi;     // their staged FiLM tables, -1: read global
  const float* s_bias;      // every layer's biases
  const float* s_tab;       // [slot][l_geo + l_app][f | p][hidden]
  size_t grow_lo, grow_hi;  // their global rows

  // A fragment of K block [col, col + 16) from a shared bf16 tile
  __device__ __forceinline__ void load_a(const bf16* base, int pitch, int col,
                                         uint32_t* a) const {
    const bf16* lo = base + r_lo * pitch + col + 2 * t;
    const bf16* hi = base + r_hi * pitch + col + 2 * t;
    a[0] = *reinterpret_cast<const uint32_t*>(lo);
    a[1] = *reinterpret_cast<const uint32_t*>(hi);
    a[2] = *reinterpret_cast<const uint32_t*>(lo + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(hi + 8);
  }

  // one K block of a layer: the chunk's stage is waited for at its first
  // block; at its last, the previous chunk's products are waited for and
  // its stage released (one chunk of products stays in flight)
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

  // one layer: PASSES column passes of NP columns each (NP = min(n_dev,
  // 128)), every pass over the whole K; the passes' epilogues fill `fout`,
  // which becomes the registers' buffer at the end
  template <int NP, int PASSES>
  __device__ __forceinline__ void layer(const int* d, float* acc,
                                        uint32_t* frag, uint32_t* fout,
                                        Pipe& p, int& reg_buf) const {
    const int n_seg = d[P_NSEG];
    const int nkb = d[P_KTOTAL] >> 4;
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      int kb = 0;
      for (int s = 0; s < n_seg; ++s) {
        const int src = d[1 + 3 * s], col = d[2 + 3 * s];
        const int sk = d[3 + 3 * s] >> 4;
        if (src == reg_buf) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (j < sk) {
              mma<NP>(acc, frag + 4 * j, kb, nkb, p);
              ++kb;
            }
          }
        } else {
          const bf16* base = src == BUF_IN ? s_in : s_stash;
          const int pitch = src == BUF_IN ? in_pitch : h_pitch;
          for (int j = 0; j < sk; ++j) {
            uint32_t a[4];
            load_a(base, pitch, col + 16 * j, a);
            mma<NP>(acc, a, kb, nkb, p);
            // `a` is read by the product after issue: let it finish before
            // the next block reuses the registers
            wgmma_commit();
            wgmma_wait<0>();
            ++kb;
          }
        }
      }
      wgmma_wait<0>();
      fence_regs<NP / 2>(acc);
      if (lane == 0) mbar_arrive(&empty[p.prev]);
      p.prev = -1;
      epilogue<NP>(d, acc, fout + pass * (NP / 4), pass * NP);
    }
    if (d[P_KIND] == LIN_OUT) return;
    if (d[P_STASH]) {
      // the registers' buffer is read again after this layer: keep it
#pragma unroll
      for (int kb = 0; kb < 16; ++kb) {
        if (kb < (hidden >> 4)) {
          bf16* lo = s_stash + r_lo * h_pitch + 16 * kb + 2 * t;
          bf16* hi = s_stash + r_hi * h_pitch + 16 * kb + 2 * t;
          *reinterpret_cast<uint32_t*>(lo) = frag[4 * kb];
          *reinterpret_cast<uint32_t*>(hi) = frag[4 * kb + 1];
          *reinterpret_cast<uint32_t*>(lo + 8) = frag[4 * kb + 2];
          *reinterpret_cast<uint32_t*>(hi + 8) = frag[4 * kb + 3];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PASSES * NP / 4; ++i) frag[i] = fout[i];
    reg_buf = d[P_DST];
  }

  // the FiLM frequencies (which 0) or phases (1) of a layer for a row of
  // batch element eb: the staged copy in shared memory, else the tables
  // in device memory
  __device__ __forceinline__ const float* film_row(const int* d, int eb,
                                                   int slot,
                                                   int which) const {
    const int film = d[P_FILM], chunk = d[P_CHUNK];
    if (slot >= 0) {
      return s_tab + ((size_t)(slot * (l_geo + l_app)
                               + (film == 0 ? 0 : l_geo) + chunk) * 2
                      + which) * hidden;
    }
    const int n_film = film == 0 ? l_geo : l_app;
    const float* tab = film == 0 ? (which ? pgeo : fgeo)
                                 : (which ? papp : fapp);
    return tab + ((size_t)(eb < 0 ? 0 : eb) * n_film + chunk) * hidden;
  }

  // bias, then FiLM sine (FILM), bf16 A fragments into `fo` (FILM,
  // LIN_BUF), or (optionally sigmoid) output columns (LIN_OUT); columns
  // c0 .. c0 + NP of the layer
  template <int NP>
  __device__ __forceinline__ void epilogue(const int* d, float* acc,
                                           uint32_t* fo, int c0) const {
    const int kind = d[P_KIND];
    const int n_pad = d[P_NPAD];
    const float* bias = s_bias + d[P_BOFF];
    if (kind == LIN_OUT) {
      const int n_valid = d[P_NVALID], split = d[P_SPLIT];
      const int out0 = d[P_OUT0], sig0 = d[P_SIG0];
      const int out1 = d[P_OUT1], sig1 = d[P_SIG1];
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) {
        const int c = c0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const bool hi = (i & 2) != 0;
        if (c < n_valid && (hi ? eb_hi : eb_lo) >= 0) {
          const bool first = c < split;
          const int oc = first ? out0 + c : out1 + (c - split);
          float x = acc[i] + s_bias[d[P_BOFF] + c];
          if (first ? sig0 : sig1) x = 1.f / (1.f + expf(-x));
          out[(hi ? grow_hi : grow_lo) * out_dim + oc] = x;
        }
      }
      return;
    }
    const bool film = kind == FILM;
    const float* f_lo = film_row(d, eb_lo, slot_lo, 0);
    const float* q_lo = film_row(d, eb_lo, slot_lo, 1);
    const float* f_hi = film_row(d, eb_hi, slot_hi, 0);
    const float* q_hi = film_row(d, eb_hi, slot_hi, 1);
    if (c0 + NP <= n_pad && eb_lo >= 0 && eb_hi >= 0) {
      // every column and row of the pass is real: no masks (all but the
      // last tile of a call)
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const int c = c0 + 8 * j + 2 * t;
        const float2 b = *reinterpret_cast<const float2*>(bias + c);
        float v0 = acc[4 * j] + b.x, v1 = acc[4 * j + 1] + b.y;
        float v2 = acc[4 * j + 2] + b.x, v3 = acc[4 * j + 3] + b.y;
        if (film) {
          const float2 fl = *reinterpret_cast<const float2*>(f_lo + c);
          const float2 ql = *reinterpret_cast<const float2*>(q_lo + c);
          const float2 fh = *reinterpret_cast<const float2*>(f_hi + c);
          const float2 qh = *reinterpret_cast<const float2*>(q_hi + c);
          v0 = fast_sin(fl.x * v0 + ql.x);
          v1 = fast_sin(fl.y * v1 + ql.y);
          v2 = fast_sin(fh.x * v2 + qh.x);
          v3 = fast_sin(fh.y * v3 + qh.y);
        }
        acc[4 * j] = v0;
        acc[4 * j + 1] = v1;
        acc[4 * j + 2] = v2;
        acc[4 * j + 3] = v3;
      }
      acc_to_afrag<NP>(acc, fo);
      return;
    }
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const int c = c0 + 8 * j + 2 * t;
      // branch-free: every value is computed and the masked ones are
      // dropped by a select; a branch per element would split the unrolled
      // loop into blocks the compiler cannot interleave
      const bool in = c < n_pad;
      const int cc = in ? c : 0;
      const float2 b = *reinterpret_cast<const float2*>(bias + cc);
      float v0 = acc[4 * j] + b.x, v1 = acc[4 * j + 1] + b.y;
      float v2 = acc[4 * j + 2] + b.x, v3 = acc[4 * j + 3] + b.y;
      bool ok_lo = in, ok_hi = in;
      if (film) {
        const float2 fl = *reinterpret_cast<const float2*>(f_lo + cc);
        const float2 ql = *reinterpret_cast<const float2*>(q_lo + cc);
        const float2 fh = *reinterpret_cast<const float2*>(f_hi + cc);
        const float2 qh = *reinterpret_cast<const float2*>(q_hi + cc);
        v0 = fast_sin(fl.x * v0 + ql.x);
        v1 = fast_sin(fl.y * v1 + ql.y);
        v2 = fast_sin(fh.x * v2 + qh.x);
        v3 = fast_sin(fh.y * v3 + qh.y);
        ok_lo = in && eb_lo >= 0;
        ok_hi = in && eb_hi >= 0;
      }
      v0 = ok_lo ? v0 : 0.f;
      v1 = ok_lo ? v1 : 0.f;
      v2 = ok_hi ? v2 : 0.f;
      v3 = ok_hi ? v3 : 0.f;
      acc[4 * j] = v0;
      acc[4 * j + 1] = v1;
      acc[4 * j + 2] = v2;
      acc[4 * j + 3] = v3;
    }
    acc_to_afrag<NP>(acc, fo);
  }
};

__global__ void __launch_bounds__(THREADS, 1)
film_mlp_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                const bf16* __restrict__ gf, const float* __restrict__ fgeo,
                const float* __restrict__ pgeo, const float* __restrict__ fapp,
                const float* __restrict__ papp,
                const bf16* __restrict__ wdev,
                const float* __restrict__ biases,
                const int* __restrict__ program, int n_layers, int rows,
                int n_per_batch, int hidden, int g, int l_geo, int l_app,
                int in_width, int stash, int max_n_dev, int out_dim,
                int n_bias, int n_tiles, float* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled stages need 1024-byte alignment (the launch adds the slack)
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Layout L = make_layout(in_width, hidden, max_n_dev, stash, n_bias,
                               l_geo + l_app);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer: the weight chunks of every layer, for every tile ----
    setmaxnreg_dec<24>();
    if (tid == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int li = 0; li < n_layers; ++li) {
          const int* d = program + li * LAYER_INTS;
          const int np = d[P_NDEV] < PASS ? d[P_NDEV] : PASS;
          const uint32_t bytes = (uint32_t)np * 128;
          const bf16* src = wdev + d[P_DOFF];
          const int n_chunks = d[P_NCHUNK];
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
  const int cw = tid >> 7;   // consumer warpgroup 0 / 1
  const int ltid = tid & 127;
  const int warp = ltid >> 5;
  Consumer C;
  C.fgeo = fgeo; C.pgeo = pgeo; C.fapp = fapp; C.papp = papp;
  C.out = out;
  C.hidden = hidden; C.l_geo = l_geo; C.l_app = l_app;
  C.out_dim = out_dim;
  C.full = full; C.empty = empty;
  C.stage0 = smem_u32(smem + L.off_w);
  C.stage_bytes = L.stage_bytes; C.stages = L.stages;
  bf16* s_in = reinterpret_cast<bf16*>(smem + L.off_in)
               + cw * WG_ROWS * L.in_pitch;
  C.s_in = s_in;
  C.in_pitch = L.in_pitch;
  C.s_stash = reinterpret_cast<bf16*>(smem + L.off_stash)
              + cw * WG_ROWS * L.h_pitch;
  C.h_pitch = L.h_pitch;
  int* s_row = reinterpret_cast<int*>(smem + L.off_row) + cw * WG_ROWS;
  C.lane = tid & 31;
  C.t = C.lane & 3;
  C.r_lo = warp * 16 + (C.lane >> 2);
  C.r_hi = C.r_lo + 8;
  const int n_film = l_geo + l_app;
  float* s_bias = reinterpret_cast<float*>(smem + L.off_bias);
  float* s_tab = reinterpret_cast<float*>(smem + L.off_tab);
  C.s_bias = s_bias;
  C.s_tab = s_tab;
  // the epilogue's operands in shared memory: every bias once, the FiLM
  // tables of the (at most two) batch elements of a tile when they change
  for (int i = tid; i < n_bias; i += 256) s_bias[i] = biases[i];
  int staged = -1;     // first batch element of the staged tables
  int staged_n = 0;    // and how many elements' tables are staged

  Pipe p = {0, 0u, -1};
  float acc[PASS / 2];
  uint32_t frag[64], fout[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) frag[i] = fout[i] = 0u;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE + cw * WG_ROWS;
    const int eb0 = tile * TILE / n_per_batch;
    const int eb1 = ((tile + 1) * TILE < rows ? (tile + 1) * TILE : rows) - 1;
    const int n_slot = eb1 / n_per_batch - eb0 + 1;
    const bool fits = n_slot <= 2;
    // reload unless every element the tile touches is staged: a tile that
    // starts in the staged element may run into the next one, which a
    // tile wholly inside that element did not load
    if (fits && (eb0 != staged || n_slot > staged_n)) {
      named_barrier(3, 256);   // both warpgroups are done with the tables
      const int per = n_film * 2 * hidden;
      for (int i = tid; i < n_slot * per; i += 256) {
        const int sl = i / per;
        int r = i - sl * per;
        const int c = r % hidden;
        r /= hidden;
        const int which = r & 1, l = r >> 1;
        const int e = eb0 + sl;
        const float* src = l < l_geo
            ? (which ? pgeo : fgeo) + ((size_t)e * l_geo + l) * hidden
            : (which ? papp : fapp) + ((size_t)e * l_app + l - l_geo) * hidden;
        s_tab[i] = src[c];
      }
      staged = eb0;
      staged_n = n_slot;
    }
    named_barrier(3, 256);   // tables (and biases) visible; s_in free
    if (ltid < WG_ROWS) {
      const int R = row0 + ltid;
      s_row[ltid] = R < rows ? R / n_per_batch : -1;
    }
    // input tile [points(3) pad | dirs(3) pad | grid feats(g) pad], bf16
    for (int i = ltid; i < WG_ROWS * in_width; i += 128) {
      const int r = i / in_width;
      const int c = i - r * in_width;
      const int R = row0 + r;
      float v = 0.f;
      if (R < rows) {
        if (c < 3) {
          v = pts[(size_t)R * 3 + c];
        } else if (c >= 16 && c < 19) {
          v = dirs[(size_t)R * 3 + (c - 16)];
        } else if (c >= 32 && c - 32 < g) {
          v = __bfloat162float(gf[(size_t)R * g + (c - 32)]);
        }
      }
      s_in[r * L.in_pitch + c] = __float2bfloat16_rn(v);
    }
    named_barrier(1 + cw, 128);
    C.eb_lo = s_row[C.r_lo];
    C.eb_hi = s_row[C.r_hi];
    C.slot_lo = fits && C.eb_lo >= 0 ? C.eb_lo - eb0 : -1;
    C.slot_hi = fits && C.eb_hi >= 0 ? C.eb_hi - eb0 : -1;
    C.grow_lo = (size_t)(row0 + C.r_lo);
    C.grow_hi = (size_t)(row0 + C.r_hi);

    int reg_buf = -1;   // the buffer the A fragments hold
    for (int li = 0; li < n_layers; ++li) {
      const int* d = program + li * LAYER_INTS;
      switch (d[P_NDEV]) {
        case 16: C.layer<16, 1>(d, acc, frag, fout, p, reg_buf); break;
        case 32: C.layer<32, 1>(d, acc, frag, fout, p, reg_buf); break;
        case 64: C.layer<64, 1>(d, acc, frag, fout, p, reg_buf); break;
        case 128:
          C.layer<PASS, 128 / PASS>(d, acc, frag, fout, p, reg_buf);
          break;
        default:
          C.layer<PASS, 256 / PASS>(d, acc, frag, fout, p, reg_buf);
          break;
      }
    }
  }
}

int g_num_sms = 0;

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
int film_mlp_forward(const void* pts, const void* dirs, const void* gf,
                     const void* fgeo, const void* pgeo, const void* fapp,
                     const void* papp, const void* wdev,
                     const void* biases, const void* program, int n_layers,
                     int rows, int n_per_batch, int hidden, int g, int l_geo,
                     int l_app, int in_width, int stash, int max_n_dev,
                     int out_dim, int n_bias, void* out, void* stream) {
  const Layout L = make_layout(in_width, hidden, max_n_dev, stash, n_bias,
                               l_geo + l_app);
  if (L.stages < 2) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      film_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L.total + 1024);
  if (err != cudaSuccess) return (int)err;
  if (g_num_sms == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&g_num_sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_tiles = (rows + TILE - 1) / TILE;
  const int blocks = n_tiles < g_num_sms ? n_tiles : g_num_sms;
  film_mlp_kernel<<<blocks, THREADS, L.total + 1024,
                    (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)dirs, (const bf16*)gf,
      (const float*)fgeo, (const float*)pgeo, (const float*)fapp,
      (const float*)papp, (const bf16*)wdev, (const float*)biases,
      (const int*)program, n_layers, rows, n_per_batch, hidden, g, l_geo,
      l_app, in_width, stash, max_n_dev, out_dim, n_bias, n_tiles,
      (float*)out);
  return (int)cudaGetLastError();
}

const char* film_mlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
