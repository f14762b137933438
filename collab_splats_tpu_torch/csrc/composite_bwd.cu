// Per-tile compositing backward: packed-map cotangents -> one gradient
// column per intersection.
//
// Replaces the Pallas kernel collab_splats_tpu/ops/pallas/composite.py::
// composite_tiles_bwd_call (composite_bwd_kernel), the backward of
// composite_fwd.cu.  Contract: d_isect [D, M] equals ops/cuda/composite.py::
// composite_tiles_bwd_plain; it is written only in the chunks the forward
// ran (nchunks) and only in the 12 + C rows the compositor reads, and the
// caller passes it zeroed.  Per tile, over its first nchunks chunks:
//
// Phase 1 replays the forward and keeps, per chunk and pixel, the log T
// carried into the chunk and the sum over its slots of g_w * w, with
//   g_w = g_colour . colour + g_normal . normal + g_depth * tpix;
// it also finds the maximum weight wmax and whether the median crossed
// 1/2 (the forward's found flag, from the same expression).
// Phase 2 walks the chunks again and, per (pixel, slot), with t_in =
// exp(lc) / (1 - alpha), suffix = the sum of g_w * w over the later slots
// of the chunk plus the later chunks' sums, t_final = exp(log T after the
// processed chunks):
//   d_alpha = (g_w t_in - suffix / (1 - alpha) + g_alpha t_final / (1 - alpha))
//             on live slots,
//   g_t     = (g_depth w + g_median [slot is the median slot]) where the
//             slot is live and its depth is above the near plane,
//   d_raw   = d_alpha where opac exp(-clip(sigma)) < 0.999,
//   d_sigma = -raw d_raw,
// and reduces over the tile's 256 pixels, per slot: d_mean = -sum(d_sigma
// (conic . d) + g_t plane), d_conic = sums of d_sigma (du^2/2, du dv,
// dv^2/2), d_depth/plane = sums of g_t (1, du, dv), d_opac = sum d_raw
// exp(-clip(sigma)), d_normal = sum g_normal w, d_colour = sum g_colour w.
// The median slot is the forward's: the first live slot with lc <= log 1/2,
// else (no crossing) the first slot whose w equals wmax.
//
// Bound on the H100: operations -- per (pixel, slot) pair of the processed
// chunks the alpha chain (~23 FP32 operations), and per live pair the
// transmittance (exp, log1p, division), g_w (C + 4 FMAs), d_alpha, g_t,
// d_sigma and the 12 + C products and adds of the pixel sums.
//
// Design: one block per 16x16 tile, one thread per pixel.  Each chunk's
// 12 + C rows are staged in shared memory for both phases.  Phase 1's
// per-chunk stores go to a global scratch [T, 2, max_chunks, 256] the
// wrapper allocates, each thread reading back only its own entries, so any
// max_chunks works.  Phase 2 first walks the chunk front to back to find
// the median slot of the chunk and to keep the in-chunk carry at every
// 32-slot boundary; then it walks the chunk back to front in 32-slot
// batches, each batch's log-transmittances rebuilt front to back from its
// boundary carry with the forward's rounding into a [32, 256] shared table
// (no transmittance is recovered by dividing through 1 - alpha), with the
// in-chunk suffix in a register.  Each slot's 12 + C pixel sums are reduced
// per warp with shuffles (skipped, as zeros, when no pixel of the warp
// sees the splat) and after the batch the 8 warps' partials are added in a
// fixed order: no atomics, so a repeated launch gives the same bits.
// Shared memory: 55 KB at C = 3, 74 KB at C = 16 (dynamic).  Never build
// with --use_fast_math: the live and median decisions must round as the
// forward's did.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kWarps = kPixels / 32;
constexpr int kChunk = 128;
constexpr int kSub = 32;
constexpr int kNSub = kChunk / kSub;
constexpr int kBase = 12;

template <int C>
constexpr int smem_floats() {
  // chunk rows, the batch's log-transmittances, warp partials
  return (kBase + C) * kChunk + kSub * kPixels + kWarps * kSub * (kBase + C);
}

// The splat chain of one (pixel, slot), in PyTorch's order of operations.
struct Slot {
  float du, dv, sigma, e, raw, alpha, t_raw, tpix;
  bool keep;
};

__device__ __forceinline__ Slot slot_chain(const float* sb, int j, float u,
                                           float v, float near_plane) {
  const float alpha_cutoff = (float)(1.0 / 255.0);
  const float alpha_max = (float)0.999;
  Slot s;
  s.du = __fsub_rn(u, sb[j]);
  s.dv = __fsub_rn(v, sb[kChunk + j]);
  const float q =
      __fadd_rn(__fmul_rn(__fmul_rn(sb[2 * kChunk + j], s.du), s.du),
                __fmul_rn(__fmul_rn(sb[4 * kChunk + j], s.dv), s.dv));
  s.sigma = __fadd_rn(__fmul_rn(0.5f, q),
                      __fmul_rn(__fmul_rn(sb[3 * kChunk + j], s.du), s.dv));
  s.e = expf(-fminf(fmaxf(s.sigma, 0.f), 50.f));
  s.raw = __fmul_rn(sb[8 * kChunk + j], s.e);
  const float a = fminf(s.raw, alpha_max);
  s.keep = s.sigma >= 0.f && a >= alpha_cutoff;
  s.alpha = s.keep ? a : 0.f;
  s.t_raw = __fadd_rn(__fadd_rn(sb[5 * kChunk + j],
                                __fmul_rn(sb[6 * kChunk + j], s.du)),
                      __fmul_rn(sb[7 * kChunk + j], s.dv));
  s.tpix = fmaxf(s.t_raw, near_plane);
  return s;
}

// w = alpha * (exp(lc) * (1 / (1 - alpha))): one expression for both phases,
// so phase 2's w equals phase 1's maximum bit for bit.
__device__ __forceinline__ float weight(float alpha, float lc, float* t_in,
                                        float* inv1m) {
  *inv1m = __fdiv_rn(1.f, __fsub_rn(1.f, alpha));
  *t_in = __fmul_rn(expf(lc), *inv1m);
  return __fmul_rn(alpha, *t_in);
}

template <int C>
__device__ __forceinline__ float grad_w(const float* sb, int j,
                                        const float* gc, const float* gn,
                                        float g_depth, float tpix) {
  float sc = 0.f, sn = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) sc = fmaf(gc[c], sb[(kBase + c) * kChunk + j], sc);
#pragma unroll
  for (int c = 0; c < 3; ++c) sn = fmaf(gn[c], sb[(9 + c) * kChunk + j], sn);
  return fmaf(g_depth, tpix, sc + sn);
}

__device__ __forceinline__ void load_chunk(float* sb, const float* src,
                                           long long m_al, int rows, int p) {
  for (int i = p; i < rows * kChunk; i += kPixels) {
    const int r = i / kChunk;
    sb[i] = src[(long long)r * m_al + (i - r * kChunk)];
  }
}

template <int C>
__global__ void __launch_bounds__(kPixels)
composite_tiles_bwd_kernel(const float* __restrict__ isect,
                           const int* __restrict__ starts,
                           const int* __restrict__ lens,
                           const int* __restrict__ nchunks,
                           const float* __restrict__ g_packed,
                           long long m_al, int ntx, float near_plane,
                           int max_chunks, float* __restrict__ scratch,
                           float* __restrict__ d_isect) {
  constexpr int R = kBase + C;  // rows read, and the per-slot pixel sums
  extern __shared__ float smem[];
  float* sb = smem;                  // [R, kChunk] chunk rows
  float* sc = sb + R * kChunk;       // [kSub, kPixels] log T after each slot
  float* sp = sc + kSub * kPixels;   // [kWarps, kSub, R] warp partials

  const float alpha_max = (float)0.999;
  const float log_half = (float)-0.6931471805599453;

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float u = (float)((tile % ntx) * kTile + p % kTile) + 0.5f;
  const float v = (float)((tile / ntx) * kTile + p / kTile) + 0.5f;
  const long long start = starts[tile];
  const int seg_len = lens[tile];
  // The forward's chunk count, clamped to the segment's walk as the
  // forward bounds it, so the scratch and the columns stay in range.
  const long long room = (m_al - start) / kChunk;
  const int nc = (int)min(
      (long long)min(nchunks[tile],
                     min((seg_len + kChunk - 1) / kChunk, max_chunks)),
      room < 0 ? 0LL : room);

  const float* g = g_packed + ((size_t)tile * kPixels + p) * (C + 6);
  float gc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gc[c] = g[c];
  const float gn[3] = {g[C], g[C + 1], g[C + 2]};
  const float g_alpha = g[C + 3];
  const float g_depth = g[C + 4];
  const float g_med = g[C + 5];
  float* logt_in = scratch + (size_t)tile * 2 * max_chunks * kPixels;
  float* gw_sum = logt_in + (size_t)max_chunks * kPixels;

  // ---- Phase 1: replay the forward.
  float log_t = 0.f, wmax = 0.f;
  bool crossed = false;
  for (int ci = 0; ci < nc; ++ci) {
    __syncthreads();  // the previous chunk is consumed
    load_chunk(sb, isect + start + (long long)ci * kChunk, m_al, R, p);
    __syncthreads();
    const int n_valid = min(kChunk, seg_len - ci * kChunk);
    float cum = 0.f, gws = 0.f;
    for (int j = 0; j < n_valid; ++j) {
      const Slot s = slot_chain(sb, j, u, v, near_plane);
      if (!s.keep) continue;
      cum = __fadd_rn(cum, log1pf(-s.alpha));
      const float lc = __fadd_rn(log_t, cum);
      crossed |= lc <= log_half;
      float t_in, inv1m;
      const float w = weight(s.alpha, lc, &t_in, &inv1m);
      gws = fmaf(grad_w<C>(sb, j, gc, gn, g_depth, s.tpix), w, gws);
      wmax = fmaxf(wmax, w);
    }
    logt_in[(size_t)ci * kPixels + p] = log_t;
    gw_sum[(size_t)ci * kPixels + p] = gws;
    log_t = __fadd_rn(log_t, cum);
  }
  const float t_final = expf(log_t);
  const float ga_tf = g_alpha * t_final;

  // ---- Phase 2: per-slot gradients, chunk by chunk.
  bool seen_med = false, seen_fb = false;
  for (int ci = 0; ci < nc; ++ci) {
    __syncthreads();
    load_chunk(sb, isect + start + (long long)ci * kChunk, m_al, R, p);
    __syncthreads();
    const int n_valid = min(kChunk, seg_len - ci * kChunk);
    const float lt_in = logt_in[(size_t)ci * kPixels + p];
    float s_after = 0.f;
    for (int c = ci + 1; c < nc; ++c) s_after += gw_sum[(size_t)c * kPixels + p];

    // Front to back: the carry at each batch boundary and the chunk's
    // median slot (the first fired live slot, else the first slot of
    // maximum weight).
    float cumb[kNSub];
    int sel = -1;
    float cum = 0.f;
#pragma unroll
    for (int b = 0; b < kNSub; ++b) {
      cumb[b] = cum;
      const int j1 = min((b + 1) * kSub, n_valid);
      for (int j = b * kSub; j < j1; ++j) {
        const Slot s = slot_chain(sb, j, u, v, near_plane);
        if (!s.keep) continue;
        cum = __fadd_rn(cum, log1pf(-s.alpha));
        const float lc = __fadd_rn(lt_in, cum);
        if (crossed) {
          if (!seen_med && lc <= log_half) {
            seen_med = true;
            sel = j;
          }
        } else if (!seen_fb && wmax > 0.f) {
          float t_in, inv1m;
          if (weight(s.alpha, lc, &t_in, &inv1m) == wmax) {
            seen_fb = true;
            sel = j;
          }
        }
      }
    }

    // Back to front, batch by batch.
    float within = 0.f;
    float* dcol = d_isect + start + (long long)ci * kChunk;
#pragma unroll
    for (int b = kNSub - 1; b >= 0; --b) {
      const int j0 = b * kSub;
      const int nb = min(kSub, n_valid - j0);
      if (nb <= 0) continue;
      // This batch's log-transmittances, rebuilt with the forward's
      // rounding; each thread reads back only its own column.
      float c2 = cumb[b];
      for (int jj = 0; jj < nb; ++jj) {
        const Slot s = slot_chain(sb, j0 + jj, u, v, near_plane);
        if (s.keep) c2 = __fadd_rn(c2, log1pf(-s.alpha));
        sc[jj * kPixels + p] = __fadd_rn(lt_in, c2);
      }
      for (int jj = nb - 1; jj >= 0; --jj) {
        const int j = j0 + jj;
        const Slot s = slot_chain(sb, j, u, v, near_plane);
        float* part = sp + (warp * kSub + jj) * R;
        if (!__any_sync(0xffffffffu, s.keep)) {
          if (lane < R) part[lane] = 0.f;
          continue;
        }
        float c[R];
#pragma unroll
        for (int i = 0; i < R; ++i) c[i] = 0.f;
        if (s.keep) {
          float t_in, inv1m;
          const float w = weight(s.alpha, sc[jj * kPixels + p], &t_in, &inv1m);
          const float gw = grad_w<C>(sb, j, gc, gn, g_depth, s.tpix);
          const float suffix = within + s_after;
          const float d_alpha = gw * t_in - suffix * inv1m + ga_tf * inv1m;
          within = fmaf(gw, w, within);
          float g_t = 0.f;
          if (s.t_raw > near_plane) g_t = g_depth * w + (j == sel ? g_med : 0.f);
          const float d_raw = s.raw < alpha_max ? d_alpha : 0.f;
          const float d_sigma = -s.raw * d_raw;
          const float* r = sb + j;
          c[0] = d_sigma * (r[2 * kChunk] * s.du + r[3 * kChunk] * s.dv) +
                 g_t * r[6 * kChunk];
          c[1] = d_sigma * (r[4 * kChunk] * s.dv + r[3 * kChunk] * s.du) +
                 g_t * r[7 * kChunk];
          c[2] = 0.5f * s.du * s.du * d_sigma;
          c[3] = s.du * s.dv * d_sigma;
          c[4] = 0.5f * s.dv * s.dv * d_sigma;
          c[5] = g_t;
          c[6] = g_t * s.du;
          c[7] = g_t * s.dv;
          c[8] = d_raw * s.e;
#pragma unroll
          for (int i = 0; i < 3; ++i) c[9 + i] = gn[i] * w;
#pragma unroll
          for (int i = 0; i < C; ++i) c[kBase + i] = gc[i] * w;
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            c[i] += __shfl_down_sync(0xffffffffu, c[i], off);
        }
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < R; ++i) part[i] = c[i];
        }
      }
      __syncthreads();
      // The 8 warps' partials in a fixed order; rows 0, 1 (the means) are
      // negated sums.
      for (int i = p; i < R * nb; i += kPixels) {
        const int r = i / nb;
        const int jj = i - r * nb;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += sp[(w * kSub + jj) * R + r];
        dcol[(long long)r * m_al + j0 + jj] = r < 2 ? -s : s;
      }
      __syncthreads();  // the partials are consumed
    }
  }
}

template <int C>
int launch(const float* isect, const int* starts, const int* lens,
           const int* nchunks, const float* g_packed, int t, long long m_al,
           int ntx, float near_plane, int max_chunks, float* scratch,
           float* d_isect, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * smem_floats<C>();
  cudaError_t err = cudaFuncSetAttribute(
      composite_tiles_bwd_kernel<C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  composite_tiles_bwd_kernel<C><<<t, kPixels, bytes, stream>>>(
      isect, starts, lens, nchunks, g_packed, m_al, ntx, near_plane,
      max_chunks, scratch, d_isect);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch; -1 for an unsupported C.
extern "C" int composite_tiles_bwd(const void* isect, const void* starts,
                                   const void* lens, const void* nchunks,
                                   const void* g_packed, int t,
                                   long long m_al, int ntx, int c,
                                   float near_plane, int max_chunks,
                                   void* scratch, void* d_isect,
                                   void* stream) {
  const auto* ip = static_cast<const float*>(isect);
  const auto* sp = static_cast<const int*>(starts);
  const auto* lp = static_cast<const int*>(lens);
  const auto* np = static_cast<const int*>(nchunks);
  const auto* gp = static_cast<const float*>(g_packed);
  auto* sc = static_cast<float*>(scratch);
  auto* dp = static_cast<float*>(d_isect);
  auto st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 3:
      return launch<3>(ip, sp, lp, np, gp, t, m_al, ntx, near_plane,
                       max_chunks, sc, dp, st);
    case 16:
      return launch<16>(ip, sp, lp, np, gp, t, m_al, ntx, near_plane,
                        max_chunks, sc, dp, st);
    default:
      return -1;
  }
}
