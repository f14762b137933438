// Batched compositing forward: every tile's front-to-back window -> maps.
//
// Replaces the Pallas kernel collab_splats_tpu/ops/pallas/batched.py::
// composite_batched_fwd (which computes the forward of the XLA fused
// compositor, core/compositing.py::fused_compositor).  For each (tile,
// pixel) and each of the K window slots, front to back:
//   alpha  = min(opac * exp(-clip(sigma, 0, 50)), 0.999), zeroed if below
//            1/255, if sigma < 0 or if the slot is masked;
//   T_excl = exp(sum of log1p(-alpha) over the slots in front);
//   w      = alpha * T_excl;
//   out_v += w * vals (normal ++ colours), depth_acc += w * tpix with
//   tpix = max(depth + plane_u du + plane_v dv, near);
//   median = tpix of the first live slot where the accumulated opacity
//            crosses 1/2 (sum of log1p(-alpha) <= log 1/2), else of the
//            first max-weight slot: a running first-max over the key
//            2 + (K - k) / K (crossed) | w (not crossed).
// alpha_out = 1 - exp(carry) and median = 0 where alpha_out is 0.
// When the caller needs a backward it passes a prefix buffer: the kernel
// then also writes the carry in front of every 64-slot batch, [K/64, T, P]
// float32, the residual the backward kernel (batched_bwd.cu) restarts its
// chain from.  The inference path passes none and writes nothing more.
//
// Bound on the H100: operations -- per (pixel, masked-in slot) pair ~23
// FP32 operations of geometry and alpha, per live pair ~11 + 2V more and
// the transcendentals; the [T, K, 9 + V] rows are read once (118 MB at
// V = 6 on the 1280x720 scene, far below the operations' time).  A splat
// covers a few pixels of its tile, so almost every pair is dead: what the
// card pays for is the dead pairs' geometry and the shared-memory reads
// that feed it, and an exp per pair with sigma >= 0 unless it is culled.
//
// Design: one block per 16x16 tile, 2 pixels per thread (PIX): a thread's
// pixels share a column, so du and the a du^2 and b du terms are formed
// once per slot for both, and each warp owns a compact 8x8 block of the
// tile.  The window is staged in 64-slot batches into shared memory as
// rows padded to whole float4s (16 floats at V = 6, 32 at V = 19) and read
// as 16-byte broadcasts:
//   u v a b | c cut opac depth | plane_u plane_v vals...
// where cut = sigma_cut(opac) (core/compositing.py), computed once per slot
// while staging.  Per pair the thread reads the first two float4s, forms
// sigma and runs the exp only if 0 <= sigma <= cut: beyond the cut alpha is
// below 1/255 whatever exp rounds to, so the cull is exact and the exact
// test decides the rest as before.  Only a live pair reads the rest of the
// row, a float4 at a time.  The batch's mask is ballot bits and only
// masked-in slots are visited; a batch with none is skipped.  Once a pixel
// has crossed 1/2 it updates no more median key: later crossed keys
// 2 + (K - k) / K do not increase with k and uncrossed keys are w <= 1, so
// none can win.  A batch's copy into shared memory does not overlap the
// walk within a block; the blocks resident on an SM (4 KB or 8 KB of
// shared memory each) overlap one another's copies and walks.  No early
// exit on transmittance: it would change outputs beyond 1e-5.
//
// Bit-level agreement with the plain version (core/compositing.py::
// fused_forward): sigma, alpha, tpix and the carry use round-to-nearest
// intrinsics in PyTorch's order of operations, and expf/log1pf are the
// same libdevice functions PyTorch's CUDA ops call, so the live set, the
// carry, the banked prefix and the median selection agree exactly; out_v
// and depth_acc are sums taken in another order than PyTorch's einsum and
// agree to float rounding.  Never build with --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kBatch = 64;

// sigma_cut (core/compositing.py): ln(255 opac) + 1e-4, +inf from 50 on.
__device__ __forceinline__ float sigma_cut(float opac) {
  const float cut = __fadd_rn(logf(__fmul_rn(opac, 255.f)), 1e-4f);
  return cut < 50.f ? cut : __int_as_float(0x7f800000);
}

// The staged position of column c of a window row (see the layout above).
__device__ __forceinline__ int staged_col(int c) {
  if (c < 5) return c;   // u v a b c
  if (c == 5) return 7;  // depth
  if (c == 8) return 6;  // opacity
  return c < 8 ? c + 2 : c + 1;  // plane_u, plane_v; vals from 10 on
}

template <int V>
struct Layout {
  static constexpr int D = 9 + V;
  static constexpr int kRow = D + 1 <= 16 ? 16 : 32;  // + the cut
  // Pixels per thread: 2 at V = 6 and at V = 19 (1 and 4 were slower at
  // both on the 1280x720 scene; 4 at V = 19 needs 168 registers).
  static constexpr int PIX = 2;
  static constexpr int kThreads = kPixels / PIX;
};

template <int V>
__global__ void __launch_bounds__(Layout<V>::kThreads)
composite_kernel(const float* __restrict__ g, const float* __restrict__ mask,
                 int k_total, int ntx, float near_plane,
                 float* __restrict__ out_v, float* __restrict__ alpha_out,
                 float* __restrict__ depth_out, float* __restrict__ median_out,
                 int* __restrict__ idx_out, float* __restrict__ prefix_out) {
  using L = Layout<V>;
  constexpr int D = L::D;
  constexpr int kRow = L::kRow;
  constexpr int PIX = L::PIX;
  constexpr int kThreads = L::kThreads;
  __shared__ __align__(16) float sg[kBatch * kRow];

  // Constants as PyTorch sees them: a Python double rounded to float.
  const float alpha_cutoff = (float)(1.0 / 255.0);
  const float alpha_max = (float)0.999;
  const float log_half = (float)-0.6931471805599453;

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // Warp w owns the 8 x 4PIX block at (8 (w % 2), 4 PIX (w / 2)); pixel i
  // of a lane lies 4 i rows below its first.
  const int px = (warp % 2) * 8 + lane % 8;
  const int py0 = (warp / 2) * 4 * PIX + lane / 8;
  const float up = (float)((tile % ntx) * kTile + px) + 0.5f;
  float vp[PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i)
    vp[i] = (float)((tile / ntx) * kTile + py0 + 4 * i) + 0.5f;
  const float* gt = g + (size_t)tile * k_total * D;
  const float* mt = mask + (size_t)tile * k_total;

  float acc[PIX][V];
  float carry[PIX], dacc[PIX], bkey[PIX], bval[PIX];
  int bidx[PIX];
  bool done[PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[i][v] = 0.f;
    // An uncovered pixel keeps slot 0, as the plain version's argmax over
    // all-zero keys does.
    carry[i] = dacc[i] = bkey[i] = bval[i] = 0.f;
    bidx[i] = 0;
    done[i] = false;
  }

  for (int k0 = 0; k0 < k_total; k0 += kBatch) {
    const int nb = min(kBatch, k_total - k0);
    if (prefix_out != nullptr) {
      float* pf = prefix_out + ((size_t)(k0 / kBatch) * gridDim.x + tile) *
                                   kPixels;
#pragma unroll
      for (int i = 0; i < PIX; ++i) pf[(py0 + 4 * i) * kTile + px] = carry[i];
    }
    // The batch's mask as bits, the same in every warp.
    const unsigned long long mbits =
        __ballot_sync(0xffffffffu, lane < nb && mt[k0 + lane] > 0.f) |
        (unsigned long long)__ballot_sync(
            0xffffffffu, lane + 32 < nb && mt[k0 + lane + 32] > 0.f)
            << 32;
    if (mbits == 0) continue;
    __syncthreads();  // the previous batch is consumed
    for (int i = tid; i < nb * D; i += kThreads) {
      const int j = i / D;
      const int c = i - j * D;
      const float x = gt[(size_t)k0 * D + i];
      sg[j * kRow + staged_col(c)] = x;
      if (c == 8) sg[j * kRow + 5] = sigma_cut(x);
    }
    __syncthreads();

    for (unsigned long long m = mbits; m != 0; m &= m - 1) {
      const int j = __ffsll((long long)m) - 1;
      const float* row = sg + j * kRow;
      const float4 q0 = *reinterpret_cast<const float4*>(row);      // u v a b
      const float4 q1 = *reinterpret_cast<const float4*>(row + 4);  // c cut
      const float du = __fsub_rn(up, q0.x);
      const float adu2 = __fmul_rn(__fmul_rn(q0.z, du), du);
      const float bdu = __fmul_rn(q0.w, du);
      const int k = k0 + j;
#pragma unroll
      for (int i = 0; i < PIX; ++i) {
        const float dv = __fsub_rn(vp[i], q0.y);
        // 0.5 * (a du du + c dv dv) + b du dv, left to right.
        const float q = __fadd_rn(adu2, __fmul_rn(__fmul_rn(q1.x, dv), dv));
        const float sigma = __fadd_rn(__fmul_rn(0.5f, q), __fmul_rn(bdu, dv));
        if (!(sigma >= 0.f) || sigma > q1.y) continue;  // dead or culled
        const float a =
            fminf(__fmul_rn(q1.z, expf(-fminf(sigma, 50.f))), alpha_max);
        if (!(a >= alpha_cutoff)) continue;
        // plane_u plane_v val0 val1, then the other values a float4 at a
        // time (fewer registers live than a whole row).
        const float4 q2 = *reinterpret_cast<const float4*>(row + 8);
        const float tpix = fmaxf(
            __fadd_rn(__fadd_rn(q1.w, __fmul_rn(q2.x, du)),
                      __fmul_rn(q2.y, dv)),
            near_plane);
        const float w = __fmul_rn(a, expf(carry[i]));
        carry[i] = __fadd_rn(carry[i], log1pf(-a));
        acc[i][0] = fmaf(w, q2.z, acc[i][0]);
        acc[i][1] = fmaf(w, q2.w, acc[i][1]);
#pragma unroll
        for (int v = 2; v < V; v += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(row + 10 + v);
          const float x[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
          for (int c = 0; c < 4 && v + c < V; ++c)
            acc[i][v + c] = fmaf(w, x[c], acc[i][v + c]);
        }
        dacc[i] = fmaf(w, tpix, dacc[i]);
        if (!done[i]) {
          if (carry[i] <= log_half) {  // the crossing: key 2 + (K - k) / K
            done[i] = true;
            bval[i] = tpix;
            bidx[i] = k;
          } else if (w > bkey[i]) {
            bkey[i] = w;
            bval[i] = tpix;
            bidx[i] = k;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const size_t o = (size_t)tile * kPixels + (py0 + 4 * i) * kTile + px;
    const float a_out = __fsub_rn(1.f, expf(carry[i]));
    alpha_out[o] = a_out;
    depth_out[o] = dacc[i];
    median_out[o] = a_out > 0.f ? bval[i] : 0.f;
    idx_out[o] = bidx[i];
#pragma unroll
    for (int v = 0; v < V; ++v) out_v[o * V + v] = acc[i][v];
  }
}

template <int V>
int launch(const float* g, const float* mask, int t, int k, int ntx,
           float near_plane, float* out_v, float* alpha, float* depth,
           float* median, int* idx, float* prefix, cudaStream_t stream) {
  composite_kernel<V><<<t, Layout<V>::kThreads, 0, stream>>>(
      g, mask, k, ntx, near_plane, out_v, alpha, depth, median, idx, prefix);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch; -1 for an unsupported V.
// ``prefix`` may be null (no backward to follow).
extern "C" int composite_batched_fwd(const void* g, const void* mask, int t,
                                     int k, int v, int ntx, float near_plane,
                                     void* out_v, void* alpha, void* depth,
                                     void* median, void* idx, void* prefix,
                                     void* stream) {
  const auto* gp = static_cast<const float*>(g);
  const auto* mp = static_cast<const float*>(mask);
  auto* ov = static_cast<float*>(out_v);
  auto* al = static_cast<float*>(alpha);
  auto* de = static_cast<float*>(depth);
  auto* me = static_cast<float*>(median);
  auto* ix = static_cast<int*>(idx);
  auto* pf = static_cast<float*>(prefix);
  auto st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 6:
      return launch<6>(gp, mp, t, k, ntx, near_plane, ov, al, de, me, ix, pf,
                       st);
    case 19:
      return launch<19>(gp, mp, t, k, ntx, near_plane, ov, al, de, me, ix, pf,
                        st);
    default:
      return -1;
  }
}
