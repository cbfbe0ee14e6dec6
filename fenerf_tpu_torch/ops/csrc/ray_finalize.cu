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
// ray_resample reads 3-4 S-vectors per ray and writes one. Both are far
// below the H100's operations-per-byte ridge.
//
// Design (simple and right first): one warp per ray, four rays per CTA. A
// ray's per-sample vectors live in shared memory (a few KB per warp); lanes
// stride over samples. Ranks are comparison counts (O(S^2 / 32) per lane,
// cheap at S <= 256); the inverse permutation gives the rank successor.
// Every prefix sum is the TPU kernel's lane-doubling (Hillis-Steele) sum in
// the same order, and products that feed a sum are rounded on their own
// (__fmul_rn: no fused multiply-add), so the plain torch versions in
// fenerf_tpu_torch/ops/ray_finalize.py repeat these additions exactly.
// Compositing: lane = channel, a sequential sum over the samples, fine
// first; the epilogue goes through a per-warp channel buffer.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;              // rays per CTA, one warp each
constexpr int THREADS = WARPS * 32;
constexpr int MAX_S = 256;            // samples per ray
constexpr int SLOTS = MAX_S / 32;     // samples per lane
constexpr int MAX_C = 128;            // output channels
constexpr int CSLOTS = MAX_C / 32;
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

// In-place prefix sum of x[0, n) in the TPU kernel's lane-doubling order:
// x[i] += x[i - sh] for sh = 1, 2, 4, ...; exclusive shifts by one more.
// Called by a whole warp; x is that warp's shared-memory row.
__device__ void prefix_sum(float* x, int n, int lane, bool exclusive) {
  float v[SLOTS];
  for (int sh = 1; sh < n; sh <<= 1) {
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int i = lane + 32 * k;
      v[k] = (i < n && i >= sh) ? x[i - sh] : 0.f;
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int i = lane + 32 * k;
      if (i < n && i >= sh) x[i] = x[i] + v[k];
    }
    __syncwarp();
  }
  if (exclusive) {
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int i = lane + 32 * k;
      v[k] = (i < n && i >= 1) ? x[i - 1] : 0.f;
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int i = lane + 32 * k;
      if (i < n) x[i] = v[k];
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// ray_resample: shared memory per warp: z[s], a[s], b[s]
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
    ray_resample_kernel(const float* __restrict__ sigma,
                        const float* __restrict__ zv,
                        const float* __restrict__ noise,
                        const float* __restrict__ u, float* __restrict__ out,
                        int rows, int s, int n_imp, int softplus) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= rows) return;  // the whole warp leaves together
  float* z = smem + warp * 3 * s;
  float* a = z + s;  // alphas -> proposal weights -> pdf -> cdf
  float* b = a + s;  // log(1 - alpha + 1e-10) -> its prefix -> the bins
  const size_t base = (size_t)row * s;
  for (int i = lane; i < s; i += 32) z[i] = zv[base + i];
  __syncwarp();
  for (int i = lane; i < s; i += 32) {
    float sg = sigma[base + i];
    if (noise != nullptr) sg = sg + noise[base + i];
    const float delta = i == s - 1 ? 1e10f : z[i + 1] - z[i];
    const float alpha = 1.f - expf(__fmul_rn(-delta, act_sigma(sg, softplus)));
    a[i] = alpha;
    b[i] = logf(1.f - alpha + 1e-10f);
  }
  __syncwarp();
  prefix_sum(b, s, lane, true);
  // interior proposal weights at positions 1..s-2 (pdf_j at j + 1)
  for (int i = lane; i < s; i += 32) {
    float wm = 0.f;
    if (i >= 1 && i <= s - 2)
      wm = (__fmul_rn(a[i], expf(b[i])) + 1e-5f) + 1e-5f;
    a[i] = wm;
  }
  __syncwarp();
  for (int i = lane; i < s - 1; i += 32) b[i] = 0.5f * (z[i] + z[i + 1]);
  __syncwarp();
  // the total as the last element of the same doubling sum, kept in z
  for (int i = lane; i < s; i += 32) z[i] = a[i];
  __syncwarp();
  prefix_sum(z, s, lane, false);
  const float total = z[s - 1];
  for (int i = lane; i < s; i += 32) a[i] = a[i] / total;
  __syncwarp();
  prefix_sum(a, s, lane, false);  // a[k] = cdf_k for k < m
  const int m = s - 1;
  const size_t ubase = (size_t)row * n_imp;
  for (int k = lane; k < n_imp; k += 32) {
    const float uk = u[ubase + k];
    int inds = 0;
    for (int j = 0; j < m; ++j) inds += a[j] < uk ? 1 : 0;
    const int below = min(max(inds - 1, 0), m - 1);
    const int above = min(max(inds, 0), m - 1);
    const float cb = a[below], ca = a[above], bb = b[below], ba = b[above];
    float denom = ca - cb;
    if (denom < 1e-5f) denom = 1.f;
    out[ubase + k] = bb + __fmul_rn((uk - cb) / denom, ba - bb);
  }
}

// ---------------------------------------------------------------------------
// ray_finalize: shared memory per warp: z[t], w[t], lo[t], rank[t], perm[t],
// cb[c] (t = sf + sc samples, c = c1 - 1 channels)
// ---------------------------------------------------------------------------
__host__ __device__ inline int finalize_floats(int t, int c) {
  return 5 * t + c;
}

__global__ void __launch_bounds__(THREADS)
    ray_finalize_kernel(const float* __restrict__ fo,
                        const float* __restrict__ co,
                        const float* __restrict__ fz,
                        const float* __restrict__ cz,
                        const float* __restrict__ noise,
                        float* __restrict__ comp, float* __restrict__ depth,
                        float* __restrict__ wsum, int rows, int sf, int sc,
                        int c1, int softplus, int last_back, int white_back,
                        int black_back, int fill_mode, float fill_value,
                        int softmax_label, int rgb_dim, int c_out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= rows) return;  // the whole warp leaves together
  const int t = sf + sc, c = c1 - 1;
  float* z = smem + warp * finalize_floats(t, c);
  float* w = z + t;   // alphas -> weights
  float* lo = w + t;  // log(1 - alpha + 1e-10) by rank -> exclusive prefix
  int* rank = reinterpret_cast<int*>(lo + t);
  int* perm = rank + t;  // perm[rank[i]] = i
  float* cb = reinterpret_cast<float*>(perm + t);
  const float* frow = fo + (size_t)row * sf * c1;
  const float* crow = co + (size_t)row * sc * c1;

  for (int i = lane; i < t; i += 32) {
    z[i] = i < sf ? fz[(size_t)row * sf + i] : cz[(size_t)row * sc + i - sf];
    perm[i] = i;  // every slot valid even if ranks collide (NaN z)
  }
  __syncwarp();
  // stable ranks: j precedes i if z_j < z_i, or z_j == z_i and j < i
  for (int i = lane; i < t; i += 32) {
    const float zi = z[i];
    int r = 0;
    for (int j = 0; j < t; ++j) {
      const float zj = z[j];
      r += (zj < zi || (zj == zi && j < i)) ? 1 : 0;
    }
    rank[i] = r;
  }
  __syncwarp();
  for (int i = lane; i < t; i += 32) perm[rank[i]] = i;
  __syncwarp();
  for (int i = lane; i < t; i += 32) {
    const int r = rank[i];
    const float delta = r == t - 1 ? 1e10f : z[perm[r + 1]] - z[i];
    float sg = i < sf ? frow[(size_t)i * c1 + c] : crow[(size_t)(i - sf) * c1 + c];
    if (noise != nullptr) sg = sg + noise[(size_t)row * t + r];
    const float alpha = 1.f - expf(__fmul_rn(-delta, act_sigma(sg, softplus)));
    w[i] = alpha;
    lo[r] = logf(1.f - alpha + 1e-10f);
  }
  __syncwarp();
  prefix_sum(lo, t, lane, true);
  float part = 0.f;
  for (int i = lane; i < t; i += 32) {
    const float wi = __fmul_rn(w[i], expf(lo[rank[i]]));
    w[i] = wi;
    part += wi;
  }
  const float ws = warp_sum(part);
  __syncwarp();
  if (last_back && lane == 0) w[perm[t - 1]] = w[perm[t - 1]] + (1.f - ws);
  __syncwarp();
  float dpart = 0.f;
  for (int i = lane; i < t; i += 32) dpart += __fmul_rn(w[i], z[i]);
  const float d = warp_sum(dpart);

  // compositing: lane = channel, samples in order, fine first
  for (int ch = lane; ch < c; ch += 32) {
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < sf; ++i) acc += w[i] * frow[(size_t)i * c1 + ch];
#pragma unroll 4
    for (int i = 0; i < sc; ++i)
      acc += w[sf + i] * crow[(size_t)i * c1 + ch];
    if (white_back) acc = acc + (1.f - ws);
    if (black_back) acc = acc - (1.f - ws);
    cb[ch] = acc;
  }
  __syncwarp();

  // fill epilogue (integrate.apply_fill) per output channel
  const bool low = ws < 0.9f;
  float v[CSLOTS];
#pragma unroll
  for (int k = 0; k < CSLOTS; ++k) {
    const int oc = lane + 32 * k;
    float x = 0.f;
    if (oc < c_out) {
      if (fill_mode == FILL_SEG_PAD)
        x = oc == 0 ? (low ? 1.f : 0.f) : (low ? fill_value : cb[oc - 1]);
      else if (fill_mode == FILL_WHITE)
        x = low ? 1.f : cb[oc];
      else if (fill_mode == FILL_DEBUG)
        x = oc == 0 ? (low ? 1.f : cb[0]) : (low ? 0.f : cb[oc]);
      else
        x = cb[oc];
    }
    v[k] = x;
  }
  if (softmax_label) {  // softmax over the channels before the rgb ones
    const int n_seg = c_out - rgb_dim;
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
    if (oc < c_out) comp[(size_t)row * c_out + oc] = v[k];
  }
  if (lane == 0) {
    depth[row] = d;
    wsum[row] = ws;
  }
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
  const int blocks = (rows + WARPS - 1) / WARPS;
  const size_t shmem = (size_t)WARPS * 3 * s * sizeof(float);
  ray_resample_kernel<<<blocks, THREADS, shmem, (cudaStream_t)stream>>>(
      (const float*)sigma, (const float*)z, (const float*)noise,
      (const float*)u, (float*)out, rows, s, n_imp, softplus);
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
  const int blocks = (rows + WARPS - 1) / WARPS;
  const size_t shmem =
      (size_t)WARPS * finalize_floats(sf + sc, c1 - 1) * sizeof(float);
  ray_finalize_kernel<<<blocks, THREADS, shmem, (cudaStream_t)stream>>>(
      (const float*)fine_out, (const float*)coarse_out, (const float*)fine_z,
      (const float*)coarse_z, (const float*)noise, (float*)comp,
      (float*)depth, (float*)wsum, rows, sf, sc, c1, softplus, last_back,
      white_back, black_back, fill_mode, fill_value, softmax_label, rgb_dim,
      c_out);
  return (int)cudaGetLastError();
}

const char* ray_finalize_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
