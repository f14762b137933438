// Batched compositing backward: pixel cotangents -> one gradient row per
// (tile, window slot).
//
// Replaces the Pallas kernel collab_splats_tpu/ops/pallas/batched_bwd.py::
// composite_batched_bwd (with the moments_to_dg recombination that follows
// it), the backward of batched_fwd.cu.  Contract: d_g [T, K, 9 + V] equals
// core/compositing.py::fused_backward (the JAX fused_bwd_from_g followed by
// moments_to_dg).  Per (tile, pixel), back to front over the window:
//   r        = g_v . vals + g_depth * tpix,   s = w * r,
//   suffix   = sum over later slots of s,
//   d_alpha  = T_excl r - suffix / (1 - alpha)
//              + g_alpha T_total / (1 - alpha),
//   d_tpix   = w g_depth + g_med [slot == median slot]  (g_med = 0 where
//              T_total == 1; d_tpix = 0 where the depth is clamped),
//   d_alpha_raw = d_alpha where the slot is live and alpha_raw < 0.999,
//   d_sigma  = -alpha_raw d_alpha_raw (0 <= sigma <= 50),
//   d_opac   = d_alpha_raw exp(-sigma),
// and the per-slot sums over the tile's 256 pixels of d_sigma (du, dv, du^2,
// du dv, dv^2), d_tpix (1, du, dv), d_opac and w g_v give the row: d_mean,
// d_conic, d_depth, d_plane, d_opacity, d_vals.  The pixel sums are taken
// directly per slot, not as moments recombined afterwards (which cancel
// near-equal terms); both agree within the gradient tolerance.
//
// Bound on the H100: operations -- per (pixel, slot) pair the forward chain
// is evaluated twice (once to rebuild the carry, once in the backward walk:
// two exp and a log1p per live pair) plus ~40 FP32 operations of the
// gradient; the [T, K, 9 + V] rows are read once and d_g written once.
//
// Design: one block per 16x16 tile, one thread per pixel, as in the
// forward.  The window is walked in 64-slot batches, back to front, with the
// running suffix sum in a register.  For each batch the rows and mask are
// staged in shared memory, and the batch's chain is rebuilt front to back
// from the forward's banked carry (prefix[b]), slot by slot with the
// forward's rounding, into a [64, 256] shared-memory table of exclusive
// log-transmittances: no transmittance is recovered by dividing through
// 1 - alpha.  Then the batch is walked back to front.  Each slot's 9 + V
// pixel sums are reduced per warp with shuffles (skipped, as zeros, when
// no pixel of the warp sees the splat), and after the batch the 8 warps'
// partials are added in a fixed order: no atomics, so the result is the
// same bits on every run.  A batch whose mask is all zero writes zeros.
// Shared memory: 98 KB at V = 6, 127 KB at V = 19 (dynamic).
// Never build with --use_fast_math: the live decisions must round as the
// forward's did.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kBatch = 64;
constexpr int kWarps = kPixels / 32;

template <int V>
constexpr int smem_floats() {
  // rows, mask, exclusive carries, warp partials
  return kBatch * (9 + V) + kBatch + kBatch * kPixels +
         kWarps * kBatch * (9 + V);
}

template <int V>
__global__ void __launch_bounds__(kPixels)
composite_bwd_kernel(const float* __restrict__ g,
                     const float* __restrict__ mask,
                     const float* __restrict__ prefix,
                     const float* __restrict__ g_v,
                     const float* __restrict__ g_alpha,
                     const float* __restrict__ g_depth,
                     const float* __restrict__ g_med,
                     const int* __restrict__ idx,
                     const float* __restrict__ t_total, int k_total, int ntx,
                     float near_plane, float* __restrict__ d_g) {
  constexpr int D = 9 + V;  // row width, and the per-slot pixel sums
  extern __shared__ float smem[];
  float* sg = smem;                     // [kBatch, D] window rows
  float* sm = sg + kBatch * D;          // [kBatch] mask
  float* sc = sm + kBatch;              // [kBatch, kPixels] exclusive carry
  float* sp = sc + kBatch * kPixels;    // [kWarps, kBatch, D] warp partials

  const float alpha_cutoff = (float)(1.0 / 255.0);
  const float alpha_max = (float)0.999;

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float up = (float)((tile % ntx) * kTile + p % kTile) + 0.5f;
  const float vp = (float)((tile / ntx) * kTile + p / kTile) + 0.5f;
  const float* gt = g + (size_t)tile * k_total * D;
  const float* mt = mask + (size_t)tile * k_total;
  float* dgt = d_g + (size_t)tile * k_total * D;

  const size_t o = (size_t)tile * kPixels + p;
  float gv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) gv[v] = g_v[o * V + v];
  const float gd = g_depth[o];
  const float tt = t_total[o];
  const float gm = tt < 1.f ? g_med[o] : 0.f;
  const float ga_tt = g_alpha[o] * tt;
  const int med = idx[o];

  float suffix = 0.f;
  const int nbatch = (k_total + kBatch - 1) / kBatch;
  for (int b = nbatch - 1; b >= 0; --b) {
    const int k0 = b * kBatch;
    const int nb = min(kBatch, k_total - k0);
    __syncthreads();  // the previous batch is consumed
    for (int i = p; i < nb * D; i += kPixels) sg[i] = gt[(size_t)k0 * D + i];
    int live = 0;
    for (int i = p; i < nb; i += kPixels) {
      const float m = mt[k0 + i];
      sm[i] = m;
      live |= m > 0.f;
    }
    if (!__syncthreads_or(live)) {
      for (int i = p; i < nb * D; i += kPixels) dgt[(size_t)k0 * D + i] = 0.f;
      continue;
    }

    // Rebuild the batch's exclusive carries from the banked prefix, in the
    // forward kernel's order of operations.
    float carry = prefix[((size_t)b * gridDim.x + tile) * kPixels + p];
    for (int j = 0; j < nb; ++j) {
      sc[j * kPixels + p] = carry;
      const float* r = sg + j * D;
      const float du = __fsub_rn(up, r[0]);
      const float dv = __fsub_rn(vp, r[1]);
      const float q = __fadd_rn(__fmul_rn(__fmul_rn(r[2], du), du),
                                __fmul_rn(__fmul_rn(r[4], dv), dv));
      const float sigma =
          __fadd_rn(__fmul_rn(0.5f, q), __fmul_rn(__fmul_rn(r[3], du), dv));
      if (sm[j] > 0.f && sigma >= 0.f) {
        const float a =
            fminf(__fmul_rn(r[8], expf(-fminf(sigma, 50.f))), alpha_max);
        if (a >= alpha_cutoff) carry = __fadd_rn(carry, log1pf(-a));
      }
    }

    // Back to front through the batch.
    for (int j = nb - 1; j >= 0; --j) {
      const float* r = sg + j * D;
      const float du = __fsub_rn(up, r[0]);
      const float dv = __fsub_rn(vp, r[1]);
      const float q = __fadd_rn(__fmul_rn(__fmul_rn(r[2], du), du),
                                __fmul_rn(__fmul_rn(r[4], dv), dv));
      const float sigma =
          __fadd_rn(__fmul_rn(0.5f, q), __fmul_rn(__fmul_rn(r[3], du), dv));
      const float tpix_raw =
          __fadd_rn(__fadd_rn(r[5], __fmul_rn(r[6], du)), __fmul_rn(r[7], dv));
      const float tpix = fmaxf(tpix_raw, near_plane);
      float alpha = 0.f, alpha_raw = 0.f, e = 0.f;
      bool keep = false;
      if (sm[j] > 0.f && sigma >= 0.f) {
        e = expf(-fminf(sigma, 50.f));
        alpha_raw = __fmul_rn(r[8], e);
        const float a = fminf(alpha_raw, alpha_max);
        if (a >= alpha_cutoff) {
          alpha = a;
          keep = true;
        }
      }
      // A dead pair adds nothing: w = 0, d_alpha_raw = 0, and the median
      // slot of a pixel is always one of its live slots.
      if (!__any_sync(0xffffffffu, keep)) {
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < D; ++c) sp[(warp * kBatch + j) * D + c] = 0.f;
        }
        continue;
      }
      float w = 0.f, d_alpha_raw = 0.f, d_tpix = 0.f;
      if (keep) {
        const float t_excl = expf(sc[j * kPixels + p]);
        w = alpha * t_excl;
        float rv = gd * tpix;
#pragma unroll
        for (int v = 0; v < V; ++v) rv = fmaf(gv[v], r[9 + v], rv);
        const float inv1m = 1.f / (1.f - alpha);
        const float d_alpha = t_excl * rv - suffix * inv1m + ga_tt * inv1m;
        suffix += w * rv;
        if (alpha_raw < alpha_max) d_alpha_raw = d_alpha;
        d_tpix = w * gd;
      }
      if (k0 + j == med) d_tpix += gm;
      if (!(tpix_raw >= near_plane)) d_tpix = 0.f;
      const float d_sigma =
          keep && sigma <= 50.f ? -alpha_raw * d_alpha_raw : 0.f;

      float c[D];
      c[0] = d_sigma * du;
      c[1] = d_sigma * dv;
      c[2] = c[0] * du;
      c[3] = c[0] * dv;
      c[4] = c[1] * dv;
      c[5] = d_tpix;
      c[6] = d_tpix * du;
      c[7] = d_tpix * dv;
      c[8] = d_alpha_raw * e;
#pragma unroll
      for (int v = 0; v < V; ++v) c[9 + v] = w * gv[v];
#pragma unroll
      for (int i = 0; i < D; ++i) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          c[i] += __shfl_down_sync(0xffffffffu, c[i], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < D; ++i) sp[(warp * kBatch + j) * D + i] = c[i];
      }
    }
    __syncthreads();

    // The 8 warps' partials, added in a fixed order, into the carry table
    // (free now): sums[j][i].
    float* sums = sc;
    for (int i = p; i < nb * D; i += kPixels) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += sp[w * kBatch * D + i];
      sums[i] = s;
    }
    __syncthreads();

    // Gradient rows of the batch, written contiguously.
    for (int i = p; i < nb * D; i += kPixels) {
      const int j = i / D;
      const int col = i - j * D;
      const float* sj = sums + j * D;
      const float* r = sg + j * D;
      float out;
      switch (col) {
        case 0:  // d_mean_u: sigma and tpix both fall as the mean moves
          out = -(r[2] * sj[0] + r[3] * sj[1] + r[6] * sj[5]);
          break;
        case 1:
          out = -(r[4] * sj[1] + r[3] * sj[0] + r[7] * sj[5]);
          break;
        case 2:  // d_a = 0.5 sum d_sigma du^2
          out = 0.5f * sj[2];
          break;
        case 3:  // d_b = sum d_sigma du dv
          out = sj[3];
          break;
        case 4:  // d_c = 0.5 sum d_sigma dv^2
          out = 0.5f * sj[4];
          break;
        default:  // d_depth, d_plane, d_opacity, d_vals: the sums as they are
          out = sj[col];
      }
      dgt[(size_t)k0 * D + i] = out;
    }
  }
}

template <int V>
int launch(const float* g, const float* mask, const float* prefix,
           const float* g_v, const float* g_alpha, const float* g_depth,
           const float* g_med, const int* idx, const float* t_total, int t,
           int k, int ntx, float near_plane, float* d_g,
           cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * smem_floats<V>();
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  composite_bwd_kernel<V><<<t, kPixels, bytes, stream>>>(
      g, mask, prefix, g_v, g_alpha, g_depth, g_med, idx, t_total, k, ntx,
      near_plane, d_g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch; -1 for an unsupported V.
extern "C" int composite_batched_bwd(const void* g, const void* mask,
                                     const void* prefix, const void* g_v,
                                     const void* g_alpha, const void* g_depth,
                                     const void* g_med, const void* idx,
                                     const void* t_total, int t, int k, int v,
                                     int ntx, float near_plane, void* d_g,
                                     void* stream) {
  const auto* gp = static_cast<const float*>(g);
  const auto* mp = static_cast<const float*>(mask);
  const auto* pf = static_cast<const float*>(prefix);
  const auto* gvp = static_cast<const float*>(g_v);
  const auto* gap = static_cast<const float*>(g_alpha);
  const auto* gdp = static_cast<const float*>(g_depth);
  const auto* gmp = static_cast<const float*>(g_med);
  const auto* ix = static_cast<const int*>(idx);
  const auto* tt = static_cast<const float*>(t_total);
  auto* out = static_cast<float*>(d_g);
  auto st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 6:
      return launch<6>(gp, mp, pf, gvp, gap, gdp, gmp, ix, tt, t, k, ntx,
                       near_plane, out, st);
    case 19:
      return launch<19>(gp, mp, pf, gvp, gap, gdp, gmp, ix, tt, t, k, ntx,
                        near_plane, out, st);
    default:
      return -1;
  }
}
