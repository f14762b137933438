// Per-tile compositing forward over chunk-aligned intersection segments,
// reading each slot's row through the aligned gaussian ids.
//
// Replaces the Pallas kernel collab_splats_tpu/ops/pallas/composite.py::
// composite_tiles_fwd (composite_fwd_kernel), the compositor of
// RenderOptions(backend="pallas").  Tile t owns the slots starts[t] ..
// starts[t] + lens[t] of the aligned intersection list and walks them front
// to back in 128-slot chunks.  Slot s reads the row per_gauss[ids[s]] of
// the [N, Dp] per-gaussian matrix (ops/rasterize.py's PG_* columns, padded
// to Dp = a multiple of 8), with sink[:, s] added to its (u, v) when a sink
// is given: the column s of the JAX package's packed matrix [D, M].  Only
// slots below lens[t] are read.  Per (pixel, slot):
//   alpha = min(opac * exp(-clip(sigma, 0, 50)), 0.999), zeroed if below
//           1/255, if sigma < 0 or past the segment's end;
//   cum   = the chunk's inclusive sum of log1p(-alpha), slot by slot;
//   lc    = log_t + cum, log_t the log-transmittance carried into the chunk;
//   w     = alpha * (exp(lc) * (1 / (1 - alpha)));
//   colour += w * colours, normal += w * normal, depth_sum += w * tpix with
//   tpix = max(depth + plane_u du + plane_v dv, near);
//   median = tpix of the first live slot with lc <= log 1/2, else of the
//            first slot of maximum weight (strict > across slots).
// After each chunk log_t += cum of its last slot.  Before each chunk the
// tile goes on only while some pixel has log_t > log(stop_threshold): a
// block-wide vote, so the early exit is tile-wide and chunk-granular as on
// the TPU; nchunks[t] records how many chunks ran (the backward's
// residual).  alpha_out = 1 - exp(log_t); median = 0 where it is 0.
// Output: packed [T, 256, C+6] (colour, normal, alpha, depth_sum, median).
//
// Bound on the H100: operations, not bytes -- per (pixel, slot) pair ~23
// FP32 operations of geometry and alpha, and for each pair whose alpha
// passes the cutoff an exp, a log1p, a division and 11 + 2(C+3) more; each
// walked slot reads an int32 id and one Dp-float row (64 or 128 bytes).
// A splat covers a few pixels of its tile, so almost every pair is dead:
// what the card pays for is the dead pairs' geometry and the shared-memory
// reads that feed it, and an exp per pair with sigma >= 0 unless culled.
//
// Design (batched_fwd.cu's): one block per 16x16 tile, 2 pixels per thread
// sharing a column, so du and the a du^2 and b du terms are formed once per
// slot for both, and each warp owns a compact 8x8 block of the tile.  Each
// chunk is gathered by one thread per slot: the slot's id, then its row as
// Dp/4 float4 loads through the read-only cache (the sink added to u and
// v), written into shared memory as a row padded to whole float4s (16
// floats at C = 3, 32 at C = 16) in composite_bwd.cu's order:
//   u v a b | c cut opac depth | plane_u plane_v normal | colours...
// where cut = sigma_cut(opac) (core/compositing.py), computed once per slot
// while staging.  Per pair the thread reads the first two float4s, forms
// sigma and runs the exp only if 0 <= sigma <= cut: beyond the cut alpha is
// below 1/255 whatever exp rounds to, so the cull is exact and the exact
// test decides the rest.  Only a live pair reads the rest of the row, a
// float4 at a time.  Dead pairs add -0.0 to the carry and 0 to every sum,
// so skipping them changes no bit.  Once a pixel has crossed 1/2 it tracks
// no maximum weight (the median is decided).  The vote at each chunk
// boundary (__syncthreads_or) also fences the shared-memory reuse; the
// blocks resident on an SM overlap one another's gathers and walks.
//
// Bit-level agreement with the plain version (ops/cuda/composite.py::
// composite_tiles_fwd_gather_plain): alpha, the carry, lc, w and tpix use
// round-to-nearest intrinsics in PyTorch's order of operations and the
// same libdevice expf/log1pf, so the median slot, the maximum weight and
// the early exit agree exactly; colour, normal and depth sums are taken in
// another order than PyTorch's einsum and agree to float rounding.  Never
// build with --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kChunk = 128;
constexpr int kBase = 12;
constexpr int PIX = 2;                    // pixels per thread
constexpr int kThreads = kPixels / PIX;   // one thread per slot of a chunk
static_assert(kThreads == kChunk, "the gather runs one thread per slot");

template <int C>
struct Layout {
  static constexpr int R = kBase + C;              // columns read
  static constexpr int kDp = (R + 7) / 8 * 8;      // per_gauss row width
  static constexpr int kRow = R + 1 <= 16 ? 16 : 32;  // staged, + the cut
};

// sigma_cut (core/compositing.py): ln(255 opac) + 1e-4, +inf from 50 on.
__device__ __forceinline__ float sigma_cut(float opac) {
  const float cut = __fadd_rn(logf(__fmul_rn(opac, 255.f)), 1e-4f);
  return cut < 50.f ? cut : __int_as_float(0x7f800000);
}

// Slot s's row, gathered through its id, into its staged position.
template <int C>
__device__ __forceinline__ void stage_slot(float* dst,
                                           const float* __restrict__ pg,
                                           int gid,
                                           const float* __restrict__ sink,
                                           long long s, long long m_al) {
  using L = Layout<C>;
  float r[L::kDp];
  const float4* src =
      reinterpret_cast<const float4*>(pg + (size_t)gid * L::kDp);
#pragma unroll
  for (int i = 0; i < L::kDp / 4; ++i) {
    const float4 q = __ldg(src + i);
    r[4 * i] = q.x;
    r[4 * i + 1] = q.y;
    r[4 * i + 2] = q.z;
    r[4 * i + 3] = q.w;
  }
  if (sink != nullptr) {
    r[0] = __fadd_rn(r[0], __ldg(sink + s));
    r[1] = __fadd_rn(r[1], __ldg(sink + m_al + s));
  }
  // PG columns: 0 u, 1 v, 2-4 conic, 5 depth, 6-7 plane, 8 opac,
  // 9-11 normal, 12.. colours.
  float st[L::kRow];
#pragma unroll
  for (int k = 0; k < 5; ++k) st[k] = r[k];
  st[5] = sigma_cut(r[8]);
  st[6] = r[8];
  st[7] = r[5];
  st[8] = r[6];
  st[9] = r[7];
#pragma unroll
  for (int k = 10; k < L::kRow; ++k) st[k] = k - 1 < L::R ? r[k - 1] : 0.f;
#pragma unroll
  for (int i = 0; i < L::kRow / 4; ++i)
    reinterpret_cast<float4*>(dst)[i] =
        make_float4(st[4 * i], st[4 * i + 1], st[4 * i + 2], st[4 * i + 3]);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
composite_tiles_fwd_kernel(const float* __restrict__ per_gauss,
                           const int* __restrict__ ids,
                           const float* __restrict__ sink,
                           const int* __restrict__ starts,
                           const int* __restrict__ lens, long long m_al,
                           int ntx, float near_plane, float log_stop,
                           int max_chunks, float* __restrict__ out,
                           int* __restrict__ nchunks_out) {
  using L = Layout<C>;
  constexpr int kRow = L::kRow;
  __shared__ __align__(16) float sb[kChunk * kRow];

  // Constants as PyTorch sees them: a Python double rounded to float.
  const float alpha_cutoff = (float)(1.0 / 255.0);
  const float alpha_max = (float)0.999;
  const float log_half = (float)-0.6931471805599453;

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // Warp w owns the 8 x 8 block at (8 (w % 2), 8 (w / 2)); a lane's second
  // pixel lies 4 rows below its first.
  const int px = (warp % 2) * 8 + lane % 8;
  const int py0 = (warp / 2) * 4 * PIX + lane / 8;
  const float up = (float)((tile % ntx) * kTile + px) + 0.5f;
  float vp[PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i)
    vp[i] = (float)((tile / ntx) * kTile + py0 + 4 * i) + 0.5f;
  const long long start = starts[tile];
  const int seg_len = lens[tile];
  // At most max_chunks, and never past the id list's end.
  const long long room = (m_al - start) / kChunk;
  const int n_chunks = (int)min(
      (long long)min((seg_len + kChunk - 1) / kChunk, max_chunks),
      room < 0 ? 0LL : room);

  float color[PIX][C], normal[PIX][3];
  float log_t[PIX], depth_sum[PIX], median[PIX], wmax[PIX], t_wmax[PIX];
  bool found[PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) color[i][c] = 0.f;
    normal[i][0] = normal[i][1] = normal[i][2] = 0.f;
    log_t[i] = depth_sum[i] = median[i] = wmax[i] = t_wmax[i] = 0.f;
    found[i] = false;
  }

  int ci = 0;
  for (; ci < n_chunks; ++ci) {
    bool going = false;
#pragma unroll
    for (int i = 0; i < PIX; ++i) going |= log_t[i] > log_stop;
    if (!__syncthreads_or(going)) break;
    const long long s0 = start + (long long)ci * kChunk;
    const int n_valid = min(kChunk, seg_len - ci * kChunk);
    if (tid < n_valid)
      stage_slot<C>(sb + tid * kRow, per_gauss, __ldg(ids + s0 + tid), sink,
                    s0 + tid, m_al);
    __syncthreads();

    float cum[PIX];
#pragma unroll
    for (int i = 0; i < PIX; ++i) cum[i] = 0.f;
    for (int j = 0; j < n_valid; ++j) {
      const float* row = sb + j * kRow;
      const float4 q0 = *reinterpret_cast<const float4*>(row);      // u v a b
      const float4 q1 = *reinterpret_cast<const float4*>(row + 4);  // c cut
      const float du = __fsub_rn(up, q0.x);
      const float adu2 = __fmul_rn(__fmul_rn(q0.z, du), du);
      const float bdu = __fmul_rn(q0.w, du);
#pragma unroll
      for (int i = 0; i < PIX; ++i) {
        const float dv = __fsub_rn(vp[i], q0.y);
        // 0.5 * (a du du + c dv dv) + b du dv, left to right.
        const float q = __fadd_rn(adu2, __fmul_rn(__fmul_rn(q1.x, dv), dv));
        const float sigma = __fadd_rn(__fmul_rn(0.5f, q), __fmul_rn(bdu, dv));
        if (!(sigma >= 0.f) || sigma > q1.y) continue;  // dead or culled
        const float alpha =
            fminf(__fmul_rn(q1.z, expf(-fminf(sigma, 50.f))), alpha_max);
        if (!(alpha >= alpha_cutoff)) continue;
        cum[i] = __fadd_rn(cum[i], log1pf(-alpha));
        const float lc = __fadd_rn(log_t[i], cum[i]);
        const float w = __fmul_rn(
            alpha,
            __fmul_rn(expf(lc), __fdiv_rn(1.f, __fsub_rn(1.f, alpha))));
        // plane_u plane_v normal0 normal1, then the rest a float4 at a time.
        const float4 q2 = *reinterpret_cast<const float4*>(row + 8);
        const float tpix = fmaxf(
            __fadd_rn(__fadd_rn(q1.w, __fmul_rn(q2.x, du)),
                      __fmul_rn(q2.y, dv)),
            near_plane);
        normal[i][0] = fmaf(w, q2.z, normal[i][0]);
        normal[i][1] = fmaf(w, q2.w, normal[i][1]);
        const float4 q3 = *reinterpret_cast<const float4*>(row + 12);
        normal[i][2] = fmaf(w, q3.x, normal[i][2]);
        color[i][0] = fmaf(w, q3.y, color[i][0]);
        color[i][1] = fmaf(w, q3.z, color[i][1]);
        color[i][2] = fmaf(w, q3.w, color[i][2]);
#pragma unroll
        for (int c = 3; c < C; c += 4) {
          const float4 qc = *reinterpret_cast<const float4*>(row + 13 + c);
          const float x[4] = {qc.x, qc.y, qc.z, qc.w};
#pragma unroll
          for (int k = 0; k < 4 && c + k < C; ++k)
            color[i][c + k] = fmaf(w, x[k], color[i][c + k]);
        }
        depth_sum[i] = fmaf(w, tpix, depth_sum[i]);
        if (!found[i]) {
          if (lc <= log_half) {
            found[i] = true;
            median[i] = tpix;
          } else if (w > wmax[i]) {
            wmax[i] = w;
            t_wmax[i] = tpix;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PIX; ++i) log_t[i] = __fadd_rn(log_t[i], cum[i]);
  }

#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const float a_out = __fsub_rn(1.f, expf(log_t[i]));
    float med = found[i] ? median[i] : t_wmax[i];
    if (!(a_out > 0.f)) med = 0.f;
    float* o = out + ((size_t)tile * kPixels + (py0 + 4 * i) * kTile + px) *
                         (C + 6);
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = color[i][c];
    o[C] = normal[i][0];
    o[C + 1] = normal[i][1];
    o[C + 2] = normal[i][2];
    o[C + 3] = a_out;
    o[C + 4] = depth_sum[i];
    o[C + 5] = med;
  }
  if (tid == 0) nchunks_out[tile] = ci;
}

template <int C>
int launch(const float* per_gauss, const int* ids, const float* sink,
           const int* starts, const int* lens, int t, long long m_al,
           int ntx, float near_plane, float log_stop, int max_chunks,
           float* out, int* nchunks, cudaStream_t stream) {
  composite_tiles_fwd_kernel<C><<<t, kThreads, 0, stream>>>(
      per_gauss, ids, sink, starts, lens, m_al, ntx, near_plane, log_stop,
      max_chunks, out, nchunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch; -1 for an unsupported C.
// ``per_gauss`` is [N, Dp] float32 (Dp = 12 + c rounded up to a multiple of
// 8, rows 16-byte aligned), ``ids`` [m_al] int32, ``sink`` [2, m_al]
// float32 or null.
extern "C" int composite_tiles_fwd(const void* per_gauss, const void* ids,
                                   const void* sink, const void* starts,
                                   const void* lens, int t, long long m_al,
                                   int ntx, int c, float near_plane,
                                   float log_stop, int max_chunks, void* out,
                                   void* nchunks, void* stream) {
  const auto* pg = static_cast<const float*>(per_gauss);
  const auto* ip = static_cast<const int*>(ids);
  const auto* kp = static_cast<const float*>(sink);
  const auto* sp = static_cast<const int*>(starts);
  const auto* lp = static_cast<const int*>(lens);
  auto* op = static_cast<float*>(out);
  auto* np = static_cast<int*>(nchunks);
  auto st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 3:
      return launch<3>(pg, ip, kp, sp, lp, t, m_al, ntx, near_plane,
                       log_stop, max_chunks, op, np, st);
    case 16:
      return launch<16>(pg, ip, kp, sp, lp, t, m_al, ntx, near_plane,
                        log_stop, max_chunks, op, np, st);
    default:
      return -1;
  }
}
