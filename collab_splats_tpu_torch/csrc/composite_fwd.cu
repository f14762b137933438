// Per-tile compositing forward over chunk-aligned intersection segments.
//
// Replaces the Pallas kernel collab_splats_tpu/ops/pallas/composite.py::
// composite_tiles_fwd (composite_fwd_kernel), the compositor of
// RenderOptions(backend="pallas").  Tile t owns the columns
// starts[t] .. starts[t] + lens[t] of the packed intersection matrix
// isect [D, M] (row layout in ops/cuda/composite.py) and walks them front
// to back in 128-column chunks.  Per (pixel, slot):
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
// passes the cutoff an exp, a log1p, a division and 11 + 2(C+3) more; the
// chunks' (12 + C) x 128 floats are read once per tile.
//
// Design: one block per 16x16 tile and one thread per pixel.  Each chunk's
// 12 + C rows are staged in shared memory (7.5 KB at C = 3, 14 KB at
// C = 16) and read by all 256 threads as broadcasts; each thread walks the
// chunk's slots in order with its carry, colour, normal, depth and median
// state in registers (C is a template parameter: 3 or 16).  Dead pairs are
// skipped: they add -0.0 to the carry and 0 to every sum, so skipping them
// changes no bit.  The vote at each chunk boundary (__syncthreads_or) also
// fences the shared-memory reuse.
//
// Bit-level agreement with the plain version (ops/cuda/composite.py::
// composite_tiles_fwd_plain): alpha, the carry, lc, w and tpix use
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

template <int C>
__global__ void __launch_bounds__(kPixels)
composite_tiles_fwd_kernel(const float* __restrict__ isect,
                           const int* __restrict__ starts,
                           const int* __restrict__ lens, long long m_al,
                           int ntx, float near_plane, float log_stop,
                           int max_chunks, float* __restrict__ out,
                           int* __restrict__ nchunks_out) {
  constexpr int R = kBase + C;  // rows the compositor reads
  __shared__ float sb[R * kChunk];

  // Constants as PyTorch sees them: a Python double rounded to float.
  const float alpha_cutoff = (float)(1.0 / 255.0);
  const float alpha_max = (float)0.999;
  const float log_half = (float)-0.6931471805599453;

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const float u = (float)((tile % ntx) * kTile + p % kTile) + 0.5f;
  const float v = (float)((tile / ntx) * kTile + p / kTile) + 0.5f;
  const long long start = starts[tile];
  const int seg_len = lens[tile];
  // At most max_chunks, and never past the matrix's end.
  const long long room = (m_al - start) / kChunk;
  const int n_chunks = (int)min(
      (long long)min((seg_len + kChunk - 1) / kChunk, max_chunks),
      room < 0 ? 0LL : room);

  float color[C];
#pragma unroll
  for (int c = 0; c < C; ++c) color[c] = 0.f;
  float normal[3] = {0.f, 0.f, 0.f};
  float log_t = 0.f, depth_sum = 0.f, median = 0.f, wmax = 0.f,
        t_wmax = 0.f;
  bool found = false;

  int ci = 0;
  for (; ci < n_chunks; ++ci) {
    if (!__syncthreads_or(log_t > log_stop)) break;
    const float* src = isect + start + (long long)ci * kChunk;
    for (int i = p; i < R * kChunk; i += kPixels) {
      const int r = i / kChunk;
      sb[i] = src[(long long)r * m_al + (i - r * kChunk)];
    }
    __syncthreads();

    const int n_valid = min(kChunk, seg_len - ci * kChunk);
    float cum = 0.f;
    for (int j = 0; j < n_valid; ++j) {
      const float du = __fsub_rn(u, sb[j]);
      const float dv = __fsub_rn(v, sb[kChunk + j]);
      // 0.5 * (a du du + c dv dv) + b du dv, left to right.
      const float q = __fadd_rn(__fmul_rn(__fmul_rn(sb[2 * kChunk + j], du), du),
                                __fmul_rn(__fmul_rn(sb[4 * kChunk + j], dv), dv));
      const float sigma = __fadd_rn(
          __fmul_rn(0.5f, q), __fmul_rn(__fmul_rn(sb[3 * kChunk + j], du), dv));
      if (!(sigma >= 0.f)) continue;
      const float alpha = fminf(
          __fmul_rn(sb[8 * kChunk + j], expf(-fminf(sigma, 50.f))), alpha_max);
      if (!(alpha >= alpha_cutoff)) continue;
      cum = __fadd_rn(cum, log1pf(-alpha));
      const float lc = __fadd_rn(log_t, cum);
      const float w = __fmul_rn(
          alpha, __fmul_rn(expf(lc), __fdiv_rn(1.f, __fsub_rn(1.f, alpha))));
      const float tpix = fmaxf(
          __fadd_rn(__fadd_rn(sb[5 * kChunk + j],
                              __fmul_rn(sb[6 * kChunk + j], du)),
                    __fmul_rn(sb[7 * kChunk + j], dv)),
          near_plane);
#pragma unroll
      for (int c = 0; c < C; ++c)
        color[c] = fmaf(w, sb[(kBase + c) * kChunk + j], color[c]);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        normal[c] = fmaf(w, sb[(9 + c) * kChunk + j], normal[c]);
      depth_sum = fmaf(w, tpix, depth_sum);
      if (w > wmax) {
        wmax = w;
        t_wmax = tpix;
      }
      if (!found && lc <= log_half) {
        found = true;
        median = tpix;
      }
    }
    log_t = __fadd_rn(log_t, cum);
  }

  const float a_out = __fsub_rn(1.f, expf(log_t));
  float med = found ? median : t_wmax;
  if (!(a_out > 0.f)) med = 0.f;
  float* o = out + ((size_t)tile * kPixels + p) * (C + 6);
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = color[c];
  o[C] = normal[0];
  o[C + 1] = normal[1];
  o[C + 2] = normal[2];
  o[C + 3] = a_out;
  o[C + 4] = depth_sum;
  o[C + 5] = med;
  if (p == 0) nchunks_out[tile] = ci;
}

template <int C>
int launch(const float* isect, const int* starts, const int* lens, int t,
           long long m_al, int ntx, float near_plane, float log_stop,
           int max_chunks, float* out, int* nchunks, cudaStream_t stream) {
  composite_tiles_fwd_kernel<C><<<t, kPixels, 0, stream>>>(
      isect, starts, lens, m_al, ntx, near_plane, log_stop, max_chunks, out,
      nchunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch; -1 for an unsupported C.
extern "C" int composite_tiles_fwd(const void* isect, const void* starts,
                                   const void* lens, int t, long long m_al,
                                   int ntx, int c, float near_plane,
                                   float log_stop, int max_chunks, void* out,
                                   void* nchunks, void* stream) {
  const auto* ip = static_cast<const float*>(isect);
  const auto* sp = static_cast<const int*>(starts);
  const auto* lp = static_cast<const int*>(lens);
  auto* op = static_cast<float*>(out);
  auto* np = static_cast<int*>(nchunks);
  auto st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 3:
      return launch<3>(ip, sp, lp, t, m_al, ntx, near_plane, log_stop,
                       max_chunks, op, np, st);
    case 16:
      return launch<16>(ip, sp, lp, t, m_al, ntx, near_plane, log_stop,
                        max_chunks, op, np, st);
    default:
      return -1;
  }
}
