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
// Bound on the H100: operations, not bytes -- the SFU transcendentals
// (exp, and the exp and log1p of every live pair) and the FP32 FMAs.  Per
// (pixel, slot) pair the kernel does ~23 FP32 operations of geometry and
// alpha; per pair whose alpha passes the cutoff ~11 more plus V FMAs.  Over
// T * 256 * K pairs (3600 * 256 * 512 on the 1280x720 scene) that takes
// several times longer than reading the [T, K, 9 + V] rows once (118 MB
// at V = 6).
//
// Design: one block per 16x16 tile and one thread per pixel.  The tile's
// window rows are staged in shared memory in batches of 64 slots (64 * 25
// floats at V = 19, 6.4 KB), read by all 256 threads as broadcasts.  Each
// thread keeps the log-transmittance carry, out_v[V], depth_acc and the
// running median key, value and slot in registers (V is a template
// parameter: 6 for RGB, 19 for rade-features).  The transcendentals run
// only for live pairs (alpha > 0) and a batch whose 64 mask entries are all
// zero is skipped; neither changes any output.  No early exit on
// transmittance: it would change outputs beyond 1e-5.
//
// Bit-level agreement with the plain version (core/compositing.py::
// fused_forward): alpha, tpix, the carry and the median key use
// round-to-nearest intrinsics in PyTorch's order of operations, and
// expf/log1pf are the same libdevice functions PyTorch's CUDA ops call, so
// the median selection agrees exactly; out_v and depth_acc are sums taken
// in another order than PyTorch's einsum and agree to float rounding.
// Never build with --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kBatch = 64;

template <int V>
__global__ void __launch_bounds__(kPixels)
composite_kernel(const float* __restrict__ g, const float* __restrict__ mask,
                 int k_total, int ntx, float near_plane,
                 float* __restrict__ out_v, float* __restrict__ alpha_out,
                 float* __restrict__ depth_out, float* __restrict__ median_out,
                 int* __restrict__ idx_out, float* __restrict__ prefix_out) {
  constexpr int D = 9 + V;
  __shared__ float sg[kBatch * D];
  __shared__ float sm[kBatch];

  // Constants as PyTorch sees them: a Python double rounded to float.
  const float alpha_cutoff = (float)(1.0 / 255.0);
  const float alpha_max = (float)0.999;
  const float log_half = (float)-0.6931471805599453;

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const float up = (float)((tile % ntx) * kTile + p % kTile) + 0.5f;
  const float vp = (float)((tile / ntx) * kTile + p / kTile) + 0.5f;
  const float* gt = g + (size_t)tile * k_total * D;
  const float* mt = mask + (size_t)tile * k_total;
  const float kf = (float)k_total;

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  float carry = 0.f, dacc = 0.f;
  float bkey = -__int_as_float(0x7f800000);  // -inf: the first slot wins
  float bval = 0.f;
  int bidx = 0;

  for (int k0 = 0; k0 < k_total; k0 += kBatch) {
    const int nb = min(kBatch, k_total - k0);
    if (prefix_out != nullptr)
      prefix_out[((size_t)(k0 / kBatch) * gridDim.x + tile) * kPixels + p] =
          carry;
    __syncthreads();  // the previous batch is consumed
    for (int i = p; i < nb * D; i += kPixels) sg[i] = gt[(size_t)k0 * D + i];
    int live = 0;
    for (int i = p; i < nb; i += kPixels) {
      const float m = mt[k0 + i];
      sm[i] = m;
      live |= m > 0.f;
    }
    if (!__syncthreads_or(live)) continue;

    for (int j = 0; j < nb; ++j) {
      const float* r = sg + j * D;
      const float du = __fsub_rn(up, r[0]);
      const float dv = __fsub_rn(vp, r[1]);
      // 0.5 * (a du du + c dv dv) + b du dv, left to right.
      const float q = __fadd_rn(__fmul_rn(__fmul_rn(r[2], du), du),
                                __fmul_rn(__fmul_rn(r[4], dv), dv));
      const float sigma =
          __fadd_rn(__fmul_rn(0.5f, q), __fmul_rn(__fmul_rn(r[3], du), dv));
      const float tpix = fmaxf(
          __fadd_rn(__fadd_rn(r[5], __fmul_rn(r[6], du)), __fmul_rn(r[7], dv)),
          near_plane);
      float alpha = 0.f;
      if (sm[j] > 0.f && sigma >= 0.f) {
        const float a =
            fminf(__fmul_rn(r[8], expf(-fminf(sigma, 50.f))), alpha_max);
        if (a >= alpha_cutoff) alpha = a;
      }
      const int k = k0 + j;
      float key = 0.f;  // w of a dead pair: alpha * T_excl == 0
      if (alpha > 0.f) {
        const float w = __fmul_rn(alpha, expf(carry));
        carry = __fadd_rn(carry, log1pf(-alpha));
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fmaf(w, r[9 + v], acc[v]);
        dacc = fmaf(w, tpix, dacc);
        key = carry <= log_half
                  ? __fadd_rn(2.f, __fdiv_rn((float)(k_total - k), kf))
                  : w;
      }
      if (key > bkey) {
        bkey = key;
        bval = tpix;
        bidx = k;
      }
    }
  }

  const size_t o = (size_t)tile * kPixels + p;
  const float a_out = __fsub_rn(1.f, expf(carry));
  alpha_out[o] = a_out;
  depth_out[o] = dacc;
  median_out[o] = a_out > 0.f ? bval : 0.f;
  idx_out[o] = bidx;
#pragma unroll
  for (int v = 0; v < V; ++v) out_v[o * V + v] = acc[v];
}

template <int V>
int launch(const float* g, const float* mask, int t, int k, int ntx,
           float near_plane, float* out_v, float* alpha, float* depth,
           float* median, int* idx, float* prefix, cudaStream_t stream) {
  composite_kernel<V><<<t, kPixels, 0, stream>>>(
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
