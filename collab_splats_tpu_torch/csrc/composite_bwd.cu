// Per-tile compositing backward: packed-map cotangents -> one gradient
// row per intersection slot.
//
// Replaces the Pallas kernel collab_splats_tpu/ops/pallas/composite.py::
// composite_tiles_bwd_call (composite_bwd_kernel), the backward of
// composite_fwd.cu, whose inputs it takes: slot s of a tile's segment reads
// the row per_gauss[ids[s]] of the [N, Dp] per-gaussian matrix, plus
// sink[:, s] on its (u, v) when a sink is given.  Contract: d_slot
// [m_al, Dp], slot-major (the rows the sorted segment sum reads), equals
// ops/cuda/composite.py::composite_tiles_bwd_gather_plain; it is written
// only in the slots of the chunks the forward ran (nchunks) below the
// segment's length, 0 in the columns past the 12 + C the compositor reads,
// and the caller passes it zeroed.  Per (pixel, slot) of a tile's first
// nchunks
// chunks, with lc the log T after the slot (as in the forward), t_in =
// exp(lc) / (1 - alpha), w = alpha t_in, suffix = the sum of g_w w over the
// later slots of the walk, t_final = exp(log T after the walk) and
//   g_w = g_colour . colour + g_normal . normal + g_depth * tpix:
//   d_alpha = (g_w t_in - suffix / (1 - alpha) + g_alpha t_final / (1 - alpha))
//             on live slots,
//   g_t     = (g_depth w + g_median [slot is the median slot]) where the
//             slot is live and its depth is above the near plane,
//   d_raw   = d_alpha where opac exp(-clip(sigma)) < 0.999,
//   d_sigma = -raw d_raw,
// reduced over the tile's 256 pixels, per slot: d_mean = -sum(d_sigma
// (conic . d) + g_t plane), d_conic = sums of d_sigma (du^2/2, du dv,
// dv^2/2), d_depth/plane = sums of g_t (1, du, dv), d_opac = sum d_raw
// exp(-clip(sigma)), d_normal = sum g_normal w, d_colour = sum g_colour w.
// The median slot is the forward's: the first live slot with lc <= log 1/2,
// else (no crossing) the first slot of maximum weight.
//
// Bound on the H100: operations -- per (pixel, slot) pair of the processed
// chunks the alpha chain (~23 FP32 operations), and per live pair the
// transmittance (exp, log1p, division), g_w, d_alpha, g_t, d_sigma and the
// 12 + C products and adds of the pixel sums.  As for batched_bwd.cu, the
// card runs a warp's instructions for all 32 pixels whenever one of them
// needs them, so it pays per (warp, slot), and each live (warp, slot)'s
// 12 + C sums must cross the warp.  So the design below replays each pair's
// chain as few times as it can, skips dead pairs and warps cheaply, and
// reduces a live slot's sums in one butterfly.
//
// Design: one block per 16x16 tile, one thread per pixel; warp w owns the
// 8x4 pixel block at (8 (w % 2), 4 (w / 2)).  Each chunk is staged in
// shared memory as 128 rows padded to whole float4s (16 floats at C = 3,
// 32 at C = 16), gathered through the slots' ids, two threads per slot
// writing whole float4s, and read as 16-byte broadcasts:
//   u v a b | c cut opac depth | plane_u plane_v normal colours...
// where cut = sigma_cut(opac) (core/compositing.py), computed once per slot
// while staging: a pair with sigma beyond it is dead whatever exp rounds
// to, so the exp runs only where 0 <= sigma <= cut (an exact cull).  Each
// staged slot also gets a mask of the warps whose 8x4 block its box
// (core/compositing.py::sigma_cut_extent, in double) reaches: a warp
// outside it skips the slot after one shared-memory read, in every pass,
// where it would otherwise form sigma for its 32 pixels.
// Phase 1 replays the forward once, front to back, and banks per chunk and
// pixel the log T carried into it and the in-chunk carry cum at each
// 32-slot batch boundary, into a global scratch [T, max_chunks, 4, 256]
// the wrapper allocates (each thread reads back only its own entries);
// it also finds the median slot: the first live slot with lc <= log 1/2,
// else the first slot of maximum weight by a running strict > (no weight
// is formed once the pixel has crossed).  Phase 2 walks the chunks and
// their 32-slot batches back to front, with the suffix in one register.
// Each batch's lc is rebuilt front to back from the banked carries into a
// [32, 256] shared table with the forward's rounding (__fadd_rn slot by
// slot), kDead marking dead pairs; then the batch is walked back to front:
// a slot that no pixel of the warp keeps costs one table read and a vote;
// otherwise each lane forms its 12 + C terms (zero where its pixel does not
// keep the slot) and a transposing butterfly (reduce-scatter, as in
// batched_bwd.cu) leaves in lane l the warp's sum of term l: 16 shuffles at
// C = 3, 31 at C = 16.  Lane l writes it over its own table entry for the
// slot, which it has read; after the batch the 8 warps' partials are added
// in a fixed order into a [12 + C, 33] table of slot sums (threads on
// consecutive terms, so no bank is read twice at once) and written out as
// the batch's consecutive Dp-float slot rows.  No atomics: a repeated launch gives the same bits.  Shared
// memory: 43.5 KB at C = 3, 53.4 KB at C = 16 (dynamic), so four blocks
// fit on an SM, and __launch_bounds__ holds the registers to 64 for them
// (at C = 16 a few values spill).  32-slot batches and four blocks ran
// faster than 64-slot batches and two or three blocks.  Never build with
// --use_fast_math: the live and median decisions must round as the
// forward's did.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kWarps = kPixels / 32;
constexpr int kChunk = 128;
constexpr int kBatch = 32;
constexpr int kNBatch = kChunk / kBatch;
constexpr int kBase = 12;
// The lc table's entry for a dead pair: a live pair's lc is negative.
constexpr float kDead = 1.f;
// Row stride of the batch's sums [R, kBatch]: odd, so that a term's sums
// over slots and a slot's sums over terms both spread over the banks.
constexpr int kSumStride = kBatch + 1;

template <int C>
struct Layout {
  static constexpr int R = kBase + C;              // rows read, pixel sums
  static constexpr int kPad = R <= 16 ? 16 : 32;   // terms a lane reduces
  static_assert(R <= 32, "one slot's sums must fit in a warp");
  static constexpr int kRow = R + 1 <= 16 ? 16 : 32;  // + the cut
  static constexpr int kDp = (R + 7) / 8 * 8;      // per_gauss row width
  // chunk rows, the batch's lc table (and the warps' partials), the
  // slots' warp masks, the batch's sums
  static constexpr int kSmemFloats =
      kChunk * kRow + kBatch * kPixels + kChunk + R * kSumStride;
};

// sigma_cut (core/compositing.py): ln(255 opac) + 1e-4, +inf from 50 on.
__device__ __forceinline__ float sigma_cut(float opac) {
  const float cut = __fadd_rn(logf(__fmul_rn(opac, 255.f)), 1e-4f);
  return cut < 50.f ? cut : __int_as_float(0x7f800000);
}

// The per_gauss column (ops/rasterize.py's PG_* layout) at staged position
// pos (see the layout above): -1 for the cut, -2 for padding.
__device__ __forceinline__ int source_row(int pos, int rows) {
  if (pos < 5) return pos;   // u v a b c
  if (pos == 5) return -1;   // cut
  if (pos == 6) return 8;    // opacity
  if (pos < 10) return pos - 2;  // depth, plane_u, plane_v
  return pos - 1 < rows ? pos - 1 : -2;  // normal, colours
}

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

// x[N] per lane (N = 16 or 32) -> the warp's sum of x[lane % N].
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

// Half-extents (eu, ev) of the box of pixel offsets at which a pair can be
// live: the box around the ellipse 0.5 d^T M d <= 1.02 cut + 0.01,
// M = [[a, b], [b, c]], widened by 0.01, in double
// (core/compositing.py::sigma_cut_extent).  A live pair has float sigma
// <= cut; float sigma errs from the exact form by under 1e-6 (a du^2 +
// c dv^2) / 2, at most 1% of the exact form where M's eigenvalues differ
// by under 1e4 times, so the box holds every live pair.  +inf where that
// bound is not known (M not so conditioned, a non-finite value, an
// infinite cut); -inf where the cut is negative (no pair is live).
__device__ __forceinline__ void cut_extent(float a, float b, float c,
                                           float cut, double& eu,
                                           double& ev) {
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  if (cut < 0.f) {
    eu = ev = -inf;
    return;
  }
  eu = ev = inf;
  if (!(cut < 50.f)) return;
  const double da = a, db = b, dc = c;
  const double det = da * dc - db * db;
  const double tr = da + dc;
  const double lmin = 0.5 * (tr - sqrt((da - dc) * (da - dc) + 4.0 * db * db));
  if (!(da > 0.0 && dc > 0.0 && det > 0.0 && lmin * 1e4 >= tr)) return;
  const double k = 2.0 * (1.02 * (double)cut + 0.01);
  eu = sqrt(k * dc / det) + 0.01;
  ev = sqrt(k * da / det) + 0.01;
}

// Bit w set iff the box of a splat at (mu, mv) reaches a pixel centre of
// warp w's bw x bh block; warps tile the 16x16 tile two blocks a row.
__device__ __forceinline__ unsigned warp_mask(float4 q0, float4 q1,
                                              float tu0, float tv0, int bw,
                                              int bh, int warps) {
  double eu, ev;
  cut_extent(q0.z, q0.w, q1.x, q1.y, eu, ev);
  unsigned m = 0u;
  for (int w = 0; w < warps; ++w) {
    const double u0 = tu0 + bw * (w % 2) + 0.5, v0 = tv0 + bh * (w / 2) + 0.5;
    if (q0.x - eu <= u0 + (bw - 1) && q0.x + eu >= u0 &&
        q0.y - ev <= v0 + (bh - 1) && q0.y + ev >= v0)
      m |= 1u << w;
  }
  return m;
}

// The first `quads` float4s of a chunk's staged rows, with the cut: two
// threads per slot, each writing whole float4s (a scalar store per value
// would conflict 16 ways in shared memory) of the row gathered through the
// slot's id, the sink added to u and v; slots past the segment's n_valid
// are not read (zeros).
template <int C>
__device__ __forceinline__ void stage_chunk(float* sb, unsigned* swm,
                                            const float* __restrict__ pg,
                                            const int* __restrict__ ids,
                                            const float* __restrict__ sink,
                                            long long s0, long long m_al,
                                            int n_valid, int quads, int p,
                                            float tu0, float tv0) {
  constexpr int kRow = Layout<C>::kRow;
  constexpr int R = Layout<C>::R;
  constexpr int kDp = Layout<C>::kDp;
  const int j = p % kChunk;
  const float* row =
      j < n_valid ? pg + (size_t)__ldg(ids + s0 + j) * kDp : nullptr;
  for (int q = p / kChunk; q < quads; q += kPixels / kChunk) {
    float x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = source_row(4 * q + k, R);
      x[k] = r >= 0 && row != nullptr ? __ldg(row + r) : 0.f;
    }
    if (q == 0 && row != nullptr && sink != nullptr) {
      x[0] = __fadd_rn(x[0], __ldg(sink + s0 + j));
      x[1] = __fadd_rn(x[1], __ldg(sink + m_al + s0 + j));
    }
    if (q == 1) x[1] = sigma_cut(x[2]);
    *reinterpret_cast<float4*>(sb + j * kRow + 4 * q) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
  __syncthreads();
  // Which warps' 8x4 blocks each slot can reach.
  if (p < kChunk)
    swm[p] = warp_mask(*reinterpret_cast<const float4*>(sb + p * kRow),
                       *reinterpret_cast<const float4*>(sb + p * kRow + 4),
                       tu0, tv0, 8, 4, kWarps);
}

// The pair's offsets and quadratic form, in PyTorch's order of operations.
__device__ __forceinline__ float pair_sigma(float4 q0, float4 q1, float u,
                                            float v, float& du, float& dv) {
  du = __fsub_rn(u, q0.x);
  dv = __fsub_rn(v, q0.y);
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(q0.z, du), du),
                            __fmul_rn(__fmul_rn(q1.x, dv), dv));
  return __fadd_rn(__fmul_rn(0.5f, q), __fmul_rn(__fmul_rn(q0.w, du), dv));
}

// The pair's alpha if it is live, else 0: the cull, then the exact test.
__device__ __forceinline__ float live_alpha(float sigma, float4 q1) {
  const float alpha_cutoff = (float)(1.0 / 255.0);
  const float alpha_max = (float)0.999;
  if (!(sigma >= 0.f) || sigma > q1.y) return 0.f;
  const float a = fminf(__fmul_rn(q1.z, expf(-fminf(sigma, 50.f))), alpha_max);
  return a >= alpha_cutoff ? a : 0.f;
}

// w = alpha * (exp(lc) * (1 / (1 - alpha))): the forward's expression.
__device__ __forceinline__ float weight(float alpha, float lc, float* t_in,
                                        float* inv1m) {
  *inv1m = __fdiv_rn(1.f, __fsub_rn(1.f, alpha));
  *t_in = __fmul_rn(expf(lc), *inv1m);
  return __fmul_rn(alpha, *t_in);
}

template <int C>
__global__ void __launch_bounds__(kPixels, 4)
composite_tiles_bwd_kernel(const float* __restrict__ per_gauss,
                           const int* __restrict__ ids,
                           const float* __restrict__ sink,
                           const int* __restrict__ starts,
                           const int* __restrict__ lens,
                           const int* __restrict__ nchunks,
                           const float* __restrict__ g_packed,
                           long long m_al, int ntx, float near_plane,
                           int max_chunks, float* __restrict__ scratch,
                           float* __restrict__ d_slot) {
  using L = Layout<C>;
  constexpr int R = L::R;
  constexpr int kDp = L::kDp;
  constexpr int kPad = L::kPad;
  constexpr int kRow = L::kRow;
  extern __shared__ __align__(16) float smem[];
  float* sb = smem;                  // [kChunk, kRow] staged chunk rows
  float* sc = sb + kChunk * kRow;    // [kBatch, kPixels] lc, then partials
  // [kChunk] bit w: the slot may be live in warp w
  unsigned* swm = reinterpret_cast<unsigned*>(sc + kBatch * kPixels);
  float* ss = reinterpret_cast<float*>(swm + kChunk);  // [R, kSumStride]

  const float alpha_max = (float)0.999;
  const float log_half = (float)-0.6931471805599453;

  const int tile = blockIdx.x;
  const int p = threadIdx.x;  // the table's column
  const int lane = p & 31;
  const int warp = p >> 5;
  const int px = (warp % 2) * 8 + lane % 8;
  const int py = (warp / 2) * 4 + lane / 8;
  const int pix = py * kTile + px;
  const float u = (float)((tile % ntx) * kTile + px) + 0.5f;
  const float v = (float)((tile / ntx) * kTile + py) + 0.5f;
  const float tu0 = (float)((tile % ntx) * kTile);
  const float tv0 = (float)((tile / ntx) * kTile);
  const unsigned my_warp = 1u << warp;
  const long long start = starts[tile];
  const int seg_len = lens[tile];
  // The forward's chunk count, clamped to the segment's walk as the
  // forward bounds it, so the scratch and the slots stay in range.
  const long long room = (m_al - start) / kChunk;
  const int nc = (int)min(
      (long long)min(nchunks[tile],
                     min((seg_len + kChunk - 1) / kChunk, max_chunks)),
      room < 0 ? 0LL : room);

  // Per (chunk, batch) and pixel: entry 0 the log T carried into the
  // chunk, entry b > 0 the in-chunk carry in front of batch b.
  float* bank = scratch + (size_t)tile * max_chunks * kNBatch * kPixels + p;

  // ---- Phase 1: replay the forward; bank the carries, find the median.
  float log_t = 0.f, wmax = 0.f;
  int sel = -1;  // the median slot, as a slot of the tile's segment
  bool crossed = false;
  for (int ci = 0; ci < nc; ++ci) {
    __syncthreads();  // the previous chunk is consumed
    const int n_valid = min(kChunk, seg_len - ci * kChunk);
    stage_chunk<C>(sb, swm, per_gauss, ids, sink,
                   start + (long long)ci * kChunk, m_al, n_valid, 2, p, tu0,
                   tv0);
    __syncthreads();
    float* bk = bank + (size_t)ci * kNBatch * kPixels;
    bk[0] = log_t;
    float cum = 0.f;
    for (int j = 0; j < n_valid; ++j) {
      if (j % kBatch == 0 && j > 0) bk[(j / kBatch) * kPixels] = cum;
      if (!(swm[j] & my_warp)) continue;  // dead in the whole warp
      const float* row = sb + j * kRow;
      const float4 q0 = *reinterpret_cast<const float4*>(row);
      const float4 q1 = *reinterpret_cast<const float4*>(row + 4);
      float du, dv;
      const float alpha = live_alpha(pair_sigma(q0, q1, u, v, du, dv), q1);
      if (alpha == 0.f) continue;
      cum = __fadd_rn(cum, log1pf(-alpha));
      if (crossed) continue;
      const float lc = __fadd_rn(log_t, cum);
      if (lc <= log_half) {
        crossed = true;
        sel = ci * kChunk + j;
        continue;
      }
      float t_in, inv1m;
      const float w = weight(alpha, lc, &t_in, &inv1m);
      if (w > wmax) {
        wmax = w;
        sel = ci * kChunk + j;
      }
    }
    log_t = __fadd_rn(log_t, cum);
  }

  const float* g = g_packed + ((size_t)tile * kPixels + pix) * (C + 6);
  float gc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gc[c] = g[c];
  const float gn[3] = {g[C], g[C + 1], g[C + 2]};
  const float g_depth = g[C + 4];
  const float g_med = g[C + 5];
  const float ga_tf = g[C + 3] * expf(log_t);  // g_alpha t_final

  // ---- Phase 2: the chunks and their batches back to front.
  float suffix = 0.f;
  for (int ci = nc - 1; ci >= 0; --ci) {
    __syncthreads();
    const int n_valid = min(kChunk, seg_len - ci * kChunk);
    stage_chunk<C>(sb, swm, per_gauss, ids, sink,
                   start + (long long)ci * kChunk, m_al, n_valid, kRow / 4,
                   p, tu0, tv0);
    __syncthreads();
    const float* bk = bank + (size_t)ci * kNBatch * kPixels;
    const float lt_in = bk[0];
    float* drow = d_slot + (size_t)(start + (long long)ci * kChunk) * kDp;
    for (int b = (n_valid - 1) / kBatch; b >= 0; --b) {
      const int j0 = b * kBatch;
      const int nb = min(kBatch, n_valid - j0);
      // The batch's lc, rebuilt with the forward's rounding; kDead where
      // the pair is dead.
      float cum = b > 0 ? bk[b * kPixels] : 0.f;
      for (int jj = 0; jj < nb; ++jj) {
        if (!(swm[j0 + jj] & my_warp)) continue;  // the walk skips it
        const float* row = sb + (j0 + jj) * kRow;
        const float4 q0 = *reinterpret_cast<const float4*>(row);
        const float4 q1 = *reinterpret_cast<const float4*>(row + 4);
        float du, dv;
        const float alpha = live_alpha(pair_sigma(q0, q1, u, v, du, dv), q1);
        float lc = kDead;
        if (alpha > 0.f) {
          cum = __fadd_rn(cum, log1pf(-alpha));
          lc = __fadd_rn(lt_in, cum);
        }
        sc[jj * kPixels + p] = lc;
      }

      // Back to front through the batch.  A dead pair adds nothing: w = 0,
      // d_alpha = 0, and the median slot is one of the pixel's live slots.
      for (int jj = nb - 1; jj >= 0; --jj) {
        const int j = j0 + jj;
        if (!(swm[j] & my_warp)) {  // no pixel of the warp keeps the slot
          sc[jj * kPixels + p] = 0.f;
          continue;
        }
        const float lc = sc[jj * kPixels + p];
        const bool keep = lc <= 0.f;
        float sum = 0.f;
        if (__any_sync(0xffffffffu, keep)) {
          float x[kPad];
#pragma unroll
          for (int i = 0; i < kPad; ++i) x[i] = 0.f;
          if (keep) {
            float r[kRow];
            load_row(sb + j * kRow, r);
            const float4 q0 = make_float4(r[0], r[1], r[2], r[3]);
            const float4 q1 = make_float4(r[4], r[5], r[6], r[7]);
            float du, dv;
            const float sigma = pair_sigma(q0, q1, u, v, du, dv);
            const float e = expf(-fminf(sigma, 50.f));  // sigma >= 0 here
            const float raw = __fmul_rn(r[6], e);
            const float alpha = fminf(raw, alpha_max);
            const float t_raw = __fadd_rn(
                __fadd_rn(r[7], __fmul_rn(r[8], du)), __fmul_rn(r[9], dv));
            float t_in, inv1m;
            const float w = weight(alpha, lc, &t_in, &inv1m);
            float sgc = 0.f, sgn = 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) sgc = fmaf(gc[c], r[13 + c], sgc);
#pragma unroll
            for (int c = 0; c < 3; ++c) sgn = fmaf(gn[c], r[10 + c], sgn);
            const float gw =
                fmaf(g_depth, fmaxf(t_raw, near_plane), sgc + sgn);
            const float d_alpha = gw * t_in - suffix * inv1m + ga_tf * inv1m;
            suffix = fmaf(gw, w, suffix);
            float g_t = 0.f;
            if (t_raw > near_plane) g_t = g_depth * w + (j + ci * kChunk == sel
                                                             ? g_med
                                                             : 0.f);
            const float d_raw = raw < alpha_max ? d_alpha : 0.f;
            const float d_sigma = -raw * d_raw;
            x[0] = d_sigma * (r[2] * du + r[3] * dv) + g_t * r[8];
            x[1] = d_sigma * (r[4] * dv + r[3] * du) + g_t * r[9];
            x[2] = 0.5f * du * du * d_sigma;
            x[3] = du * dv * d_sigma;
            x[4] = 0.5f * dv * dv * d_sigma;
            x[5] = g_t;
            x[6] = g_t * du;
            x[7] = g_t * dv;
            x[8] = d_raw * e;
#pragma unroll
            for (int i = 0; i < 3; ++i) x[9 + i] = gn[i] * w;
#pragma unroll
            for (int i = 0; i < C; ++i) x[kBase + i] = gc[i] * w;
          }
          sum = reduce_scatter<kPad>(x, lane);
        }
        // Lane l holds term l (l < R) of the warp's sum; it goes over the
        // lane's own table entry for the slot, read above.
        sc[jj * kPixels + p] = lane < R ? sum : 0.f;
      }
      __syncthreads();
      // The 8 warps' partials in a fixed order, consecutive threads on
      // consecutive terms of a slot (on consecutive slots they would read
      // one bank 32 times); rows 0, 1 (the means) are negated sums.
      for (int i = p; i < R * nb; i += kPixels) {
        const int jj = i / R;
        const int r = i - jj * R;
        const float* pj = sc + jj * kPixels + r;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += pj[w * 32];
        ss[r * kSumStride + jj] = r < 2 ? -s : s;
      }
      __syncthreads();
      // The batch's gradient rows, consecutive in d_slot: threads on
      // consecutive columns, 0 past the 12 + C.
      for (int i = p; i < kDp * nb; i += kPixels) {
        const int jj = i / kDp;
        const int r = i - jj * kDp;
        drow[(size_t)(j0 + jj) * kDp + r] = r < R ? ss[r * kSumStride + jj]
                                                  : 0.f;
      }
      __syncthreads();  // the partials and sums are consumed
    }
  }
}

template <int C>
int launch(const float* per_gauss, const int* ids, const float* sink,
           const int* starts, const int* lens, const int* nchunks,
           const float* g_packed, int t, long long m_al, int ntx,
           float near_plane, int max_chunks, float* scratch, float* d_slot,
           cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * Layout<C>::kSmemFloats;
  cudaError_t err = cudaFuncSetAttribute(
      composite_tiles_bwd_kernel<C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  composite_tiles_bwd_kernel<C><<<t, kPixels, bytes, stream>>>(
      per_gauss, ids, sink, starts, lens, nchunks, g_packed, m_al, ntx,
      near_plane, max_chunks, scratch, d_slot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entries of the scratch per (tile, chunk, pixel): the wrapper allocates
// [T, max_chunks, composite_tiles_bwd_banked(), 256] float32.
extern "C" int composite_tiles_bwd_banked() { return kNBatch; }

// Returns cudaGetLastError() after the launch; -1 for an unsupported C.
// ``per_gauss``, ``ids`` and ``sink`` (may be null) as composite_fwd.cu
// takes them; ``d_slot`` [m_al, Dp] float32, zeroed.
extern "C" int composite_tiles_bwd(const void* per_gauss, const void* ids,
                                   const void* sink, const void* starts,
                                   const void* lens, const void* nchunks,
                                   const void* g_packed, int t,
                                   long long m_al, int ntx, int c,
                                   float near_plane, int max_chunks,
                                   void* scratch, void* d_slot,
                                   void* stream) {
  const auto* pg = static_cast<const float*>(per_gauss);
  const auto* ip = static_cast<const int*>(ids);
  const auto* kp = static_cast<const float*>(sink);
  const auto* sp = static_cast<const int*>(starts);
  const auto* lp = static_cast<const int*>(lens);
  const auto* np = static_cast<const int*>(nchunks);
  const auto* gp = static_cast<const float*>(g_packed);
  auto* sc = static_cast<float*>(scratch);
  auto* dp = static_cast<float*>(d_slot);
  auto st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 3:
      return launch<3>(pg, ip, kp, sp, lp, np, gp, t, m_al, ntx,
                       near_plane, max_chunks, sc, dp, st);
    case 16:
      return launch<16>(pg, ip, kp, sp, lp, np, gp, t, m_al, ntx,
                        near_plane, max_chunks, sc, dp, st);
    default:
      return -1;
  }
}
