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
// is evaluated again (to rebuild the carry, and in the backward walk: two
// exp and a log1p per live pair) plus ~40 FP32 operations of the gradient;
// the [T, K, 9 + V] rows are read once and d_g written once.  The card runs
// a warp's instructions for all 32 pixels whenever one of them needs them,
// so what the kernel pays for is (warp, slot) pairs, and each pair's 9 + V
// per-slot sums must cross the warp: reduced one by one with 5-step
// shuffle trees they take 75 shuffles at V = 6 and 140 at V = 19, and an
// SM runs one warp shuffle per clock.
//
// Design: one block per 16x16 tile, one thread per pixel; each warp owns an
// 8x4 block of the tile's pixels, which a splat of a few pixels reaches in
// fewer warps than rows of 16x2 do.  The window is walked in 64-slot
// batches, back to front, with the running suffix sum in a register.  For
// each batch the rows are staged in shared memory (padded to whole float4s
// and read as 16-byte broadcasts), the mask is kept as ballot bits, and the
// batch's chain is rebuilt front to back from the forward's banked carry
// (prefix[b]) into a [64, 256] table of exclusive log-transmittances (no
// transmittance is recovered by dividing through 1 - alpha).  The rebuild
// decides which pairs are live, with the forward's rounding, and writes
// kDead for the others.  Then the batch is walked back to front, one slot
// at a time: a slot that no pixel of the warp keeps costs one shared-memory
// read and writes zeros; otherwise each lane forms its 9 + V terms (zero
// where its pixel does not keep the slot), and a transposing butterfly
// (reduce-scatter) over xor-partners leaves in lane l the warp's sum of
// term l: 8 + 4 + 2 + 1 shuffles and one more to join the half-warps at
// V = 6 (16 terms), 31 at V = 19 (32 terms).  Lane l writes its sum into
// the carry table, over its own warp's entry for that slot, which is read
// no more; after the batch the 8 warps' partials are added in a fixed
// order.  No atomics, and every sum is taken in a fixed order, so the
// result is the same bits on every run.  A batch whose mask is all zero
// writes zeros.  The carry, T_excl and 1 / (1 - alpha) use log1pf, expf
// and a true division, as the forward and the plain version do.
// Shared memory: 73 KB at V = 6, 80 KB at V = 19 (dynamic); at V = 6 three
// blocks fit on an SM (nvcc -Xptxas -v prints the registers).
// Never build with --use_fast_math: the live decisions must round as the
// forward's did.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kBatch = 64;
constexpr int kWarps = kPixels / 32;
// The carry table's entry for a dead pair: carries are never positive.
constexpr float kDead = 1.f;

template <int V>
struct Layout {
  static constexpr int D = 9 + V;                // row width, per-slot sums
  static constexpr int kPad = D <= 16 ? 16 : 32;  // terms a lane reduces
  static_assert(D <= 32, "one slot's sums must fit in a warp");
  // A staged row's stride: whole float4s, read as 16-byte broadcasts.
  static constexpr int kRow = (D + 3) / 4 * 4;
  // rows, exclusive carries (and the warps' partials), slot sums
  static constexpr int kSmemFloats =
      kBatch * kRow + kBatch * kPixels + kBatch * D;
};

// One stage of the butterfly below: a lane keeps the half of its first 2H
// values selected by bit H of its id, sends its xor-partner the other half
// and adds what the partner sends back.
template <int H, int N>
__device__ __forceinline__ void butterfly_stage(float (&x)[N], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = upper ? x[k] : x[k + H];
    const float keep = upper ? x[k + H] : x[k];
    x[k] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// x[N] per lane (N = 16 or 32) -> the warp's sum of x[lane % N], a
// reduce-scatter: after the stage of bit H, value k of a lane stands for
// value k + (lane & H) of the stage before.  With N = 16 the two half-warps
// hold the same terms after four stages and one more shuffle joins them.
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&x)[N], int lane) {
  if constexpr (N == 32) butterfly_stage<16>(x, lane);
  butterfly_stage<8>(x, lane);
  butterfly_stage<4>(x, lane);
  butterfly_stage<2>(x, lane);
  butterfly_stage<1>(x, lane);
  if constexpr (N == 16) return x[0] + __shfl_xor_sync(0xffffffffu, x[0], 16);
  return x[0];
}

// The slot's pixel offsets and quadratic form, in the forward's order of
// operations.
__device__ __forceinline__ void slot_sigma(const float* r, float up, float vp,
                                           float& du, float& dv,
                                           float& sigma) {
  du = __fsub_rn(up, r[0]);
  dv = __fsub_rn(vp, r[1]);
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(r[2], du), du),
                            __fmul_rn(__fmul_rn(r[4], dv), dv));
  sigma = __fadd_rn(__fmul_rn(0.5f, q), __fmul_rn(__fmul_rn(r[3], du), dv));
}

// The first N (a multiple of 4) values of a staged row, as float4 loads.
template <int N>
__device__ __forceinline__ void load_row(const float* src, float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(src + i);
    r[i] = q.x;
    r[i + 1] = q.y;
    r[i + 2] = q.z;
    r[i + 3] = q.w;
  }
}

// The register budget of 2 blocks an SM.
template <int V>
__global__ void __launch_bounds__(kPixels, 2)
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
  using L = Layout<V>;
  constexpr int D = L::D;
  constexpr int kPad = L::kPad;
  constexpr int kRow = L::kRow;
  extern __shared__ __align__(16) float smem[];
  float* sg = smem;                     // [kBatch, kRow] window rows
  float* sc = sg + kBatch * kRow;       // [kBatch, kPixels] exclusive carry
  float* ss = sc + kBatch * kPixels;    // [kBatch, D] per-slot pixel sums

  const float alpha_cutoff = (float)(1.0 / 255.0);
  const float alpha_max = (float)0.999;

  const int tile = blockIdx.x;
  const int p = threadIdx.x;  // the carry table's column
  const int lane = p & 31;
  const int warp = p >> 5;
  // This thread's pixel: warp w owns the 8x4 block at ((w % 2) 8, (w / 2) 4).
  const int px = (warp % 2) * 8 + lane % 8;
  const int py = (warp / 2) * 4 + lane / 8;
  const int pix = py * kTile + px;
  const float up = (float)((tile % ntx) * kTile + px) + 0.5f;
  const float vp = (float)((tile / ntx) * kTile + py) + 0.5f;
  const float* gt = g + (size_t)tile * k_total * D;
  const float* mt = mask + (size_t)tile * k_total;
  float* dgt = d_g + (size_t)tile * k_total * D;

  const size_t o = (size_t)tile * kPixels + pix;
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
    // The batch's mask as bits, the same in every warp: slot j is masked
    // in iff bit j is set.
    const unsigned long long mbits =
        __ballot_sync(0xffffffffu, lane < nb && mt[k0 + lane] > 0.f) |
        (unsigned long long)__ballot_sync(
            0xffffffffu, lane + 32 < nb && mt[k0 + lane + 32] > 0.f)
            << 32;
    if (mbits == 0) {
      for (int i = p; i < nb * D; i += kPixels) dgt[(size_t)k0 * D + i] = 0.f;
      continue;
    }
    __syncthreads();  // the previous batch is consumed
    for (int i = p; i < nb * D; i += kPixels)
      sg[i / D * kRow + i % D] = gt[(size_t)k0 * D + i];
    __syncthreads();

    // Rebuild the batch's exclusive carries from the banked prefix, keeping
    // them only for the live pairs: a dead pair's entry is kDead, and a
    // masked slot leaves the carry as it is and is never read.  The live
    // decision and the carry round as the forward's.
    float carry = prefix[((size_t)b * gridDim.x + tile) * kPixels + pix];
    for (int j = 0; j < nb; ++j) {
      if (!((mbits >> j) & 1)) continue;
      float r[12];
      load_row(sg + j * kRow, r);
      float du, dv, sigma;
      slot_sigma(r, up, vp, du, dv, sigma);
      // sigma < 0 is dead; the clamp only keeps such a lane finite.
      const float a = fminf(
          __fmul_rn(r[8], expf(-fminf(fmaxf(sigma, 0.f), 50.f))), alpha_max);
      const bool live = sigma >= 0.f && a >= alpha_cutoff;
      sc[j * kPixels + p] = live ? carry : kDead;
      if (live) carry = __fadd_rn(carry, log1pf(-a));
    }

    // Back to front through the batch.  A dead pair adds nothing: w = 0,
    // d_alpha_raw = 0, and the median slot of a pixel is always one of its
    // live slots.
    for (int j = nb - 1; j >= 0; --j) {
      if (!((mbits >> j) & 1)) {  // the same for the whole block
        if (lane < D) sc[j * kPixels + warp * 32 + lane] = 0.f;
        continue;
      }
      const float ex = sc[j * kPixels + p];
      const bool keep = ex <= 0.f;
      float sum = 0.f;
      if (__any_sync(0xffffffffu, keep)) {
        // Every lane forms the slot's terms, zero where it does not keep it.
        float r[kRow];
        load_row(sg + j * kRow, r);
        float du, dv, sigma;
        slot_sigma(r, up, vp, du, dv, sigma);
        // A kept pair has sigma >= 0; the clamp keeps a dead lane finite.
        const float e = expf(-fminf(fmaxf(sigma, 0.f), 50.f));
        const float alpha_raw = __fmul_rn(r[8], e);
        const float alpha = fminf(alpha_raw, alpha_max);
        const float tpix_raw = __fadd_rn(__fadd_rn(r[5], __fmul_rn(r[6], du)),
                                         __fmul_rn(r[7], dv));
        const float tpix = fmaxf(tpix_raw, near_plane);
        const float t_excl = expf(ex);
        const float w = keep ? alpha * t_excl : 0.f;
        float rv = gd * tpix;
#pragma unroll
        for (int v = 0; v < V; ++v) rv = fmaf(gv[v], r[9 + v], rv);
        const float inv1m = 1.f / (1.f - alpha);
        const float d_alpha = t_excl * rv - suffix * inv1m + ga_tt * inv1m;
        if (keep) suffix += w * rv;
        const float d_alpha_raw =
            keep && alpha_raw < alpha_max ? d_alpha : 0.f;
        float d_tpix = w * gd;
        if (k0 + j == med) d_tpix += gm;
        if (!(tpix_raw >= near_plane)) d_tpix = 0.f;
        const float d_sigma = sigma <= 50.f ? -alpha_raw * d_alpha_raw : 0.f;
        float x[kPad];
        x[0] = d_sigma * du;
        x[1] = d_sigma * dv;
        x[2] = x[0] * du;
        x[3] = x[0] * dv;
        x[4] = x[1] * dv;
        x[5] = d_tpix;
        x[6] = d_tpix * du;
        x[7] = d_tpix * dv;
        x[8] = d_alpha_raw * e;
#pragma unroll
        for (int v = 0; v < V; ++v) x[9 + v] = w * gv[v];
#pragma unroll
        for (int i = D; i < kPad; ++i) x[i] = 0.f;
        sum = reduce_scatter<kPad>(x, lane);
      }
      // Lane l holds term l (l < D) of the warp's sum.  It goes into the
      // carry table over this warp's entry of pixel l for the slot, which
      // that pixel's thread read before the vote above.
      if (lane < D) sc[j * kPixels + warp * 32 + lane] = sum;
    }
    __syncthreads();

    // The 8 warps' partials, added in a fixed order: sums[j][i].
    for (int i = p; i < nb * D; i += kPixels) {
      const int j = i / D;
      const float* pj = sc + j * kPixels + (i - j * D);
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += pj[w * 32];
      ss[i] = s;
    }
    __syncthreads();

    // Gradient rows of the batch, written contiguously.
    for (int i = p; i < nb * D; i += kPixels) {
      const int j = i / D;
      const int col = i - j * D;
      const float* sj = ss + j * D;
      const float* r = sg + j * kRow;
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
  constexpr size_t bytes = sizeof(float) * Layout<V>::kSmemFloats;
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
