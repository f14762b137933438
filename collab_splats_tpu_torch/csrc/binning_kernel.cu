// Binning decode: intersection-buffer slot -> (sort key, gaussian id).
//
// Replaces the Pallas kernel collab_splats_tpu/ops/pallas/binning_kernel.py
// ::decode_bin_keys (called from ops/tiles.py::_decode_keys_pallas).  Slot s
// of the [m_cap] buffer belongs to the gaussian g with
// offsets[g] <= s < ends[g]; it gets key = tile << rank_bits | rank[g] and
// gid = g, where tile walks g's tile bbox row-major.  With the ellipse cull,
// a slot whose tile rectangle lies wholly outside the splat's
// alpha >= 1/255 ellipse (min over the rect of sigma > log(opac/cutoff))
// is invalid.  Invalid slots, and slots past the buffer's live total, get
// the sentinel key num_tiles << rank_bits and gid 0.
//
// Bound on the H100: bytes written.  The work per slot is a handful of
// integer and float operations; the output is 8 bytes per slot (16 MB at
// 2^21 slots), read once by the key sort that follows.
//
// Design: one thread per slot, so every output word is written exactly
// once, coalesced, and no pass has to pre-fill the buffer.  The owner is
// found by a binary search over the monotone ends[] array (which stays in
// L2: 4 MB at 1M gaussians).  All integer fields are int32: the TPU
// kernel's f32 one-hot matmul gather and its f32-carried integers were a
// TPU artifact.  The cull is evaluated in exactly the order of operations
// of the plain version (ops/cuda/binning_kernel.py::_min_sigma_rect) with
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn),
// which nvcc never contracts into FMAs, so every decision is bit-identical
// to PyTorch's elementwise ops (each of which rounds once).  Never build
// with --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Constants as PyTorch sees them: a Python double rounded to float.
__device__ __forceinline__ float sig(float a, float b, float c, float du,
                                     float dv) {
  // 0.5 * (a * du * du + c * dv * dv) + b * du * dv, left to right.
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(a, du), du),
                            __fmul_rn(__fmul_rn(c, dv), dv));
  return __fadd_rn(__fmul_rn(0.5f, q), __fmul_rn(__fmul_rn(b, du), dv));
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// min over [u0,u1] x [v0,v1] of sigma; see the plain version's
// ops/cuda/binning_kernel.py::_min_sigma_rect.
__device__ __forceinline__ float min_sigma_rect(float mu, float mv, float a,
                                                float b, float c, float u0,
                                                float u1, float v0, float v1) {
  const float du0 = __fsub_rn(u0, mu), du1 = __fsub_rn(u1, mu);
  const float dv0 = __fsub_rn(v0, mv), dv1 = __fsub_rn(v1, mv);
  if (du0 <= 0.f && du1 >= 0.f && dv0 <= 0.f && dv1 >= 0.f) return 0.f;
  const float tiny = (float)1e-12;
  const float c_safe = fmaxf(c, tiny);
  const float a_safe = fmaxf(a, tiny);
  const float nb = -b;
  const float e0 = sig(a, b, c, du0,
                       clampf(__fdiv_rn(__fmul_rn(nb, du0), c_safe), dv0, dv1));
  const float e1 = sig(a, b, c, du1,
                       clampf(__fdiv_rn(__fmul_rn(nb, du1), c_safe), dv0, dv1));
  const float e2 = sig(a, b, c,
                       clampf(__fdiv_rn(__fmul_rn(nb, dv0), a_safe), du0, du1),
                       dv0);
  const float e3 = sig(a, b, c,
                       clampf(__fdiv_rn(__fmul_rn(nb, dv1), a_safe), du0, du1),
                       dv1);
  return fminf(fminf(e0, e1), fminf(e2, e3));
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const int* __restrict__ offsets, const int* __restrict__ ends,
              const int* __restrict__ ncols, const int* __restrict__ tile0,
              const int* __restrict__ rank, const float* __restrict__ cull,
              int n, int m_cap, int ntx, int ts, int rank_bits,
              int num_tiles, int* __restrict__ key_out,
              int* __restrict__ gid_out) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= m_cap) return;
  // First gaussian whose run ends after slot s.
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ends + mid) > s) hi = mid; else lo = mid + 1;
  }
  const int g = lo;
  bool valid = g < n;
  int key = 0;
  if (valid) {
    const int off = __ldg(offsets + g);
    valid = off <= s;
    const int local = s - off;
    const int nc = __ldg(ncols + g);
    const int dy = local / nc;
    const int dx = local - dy * nc;
    const int tile = __ldg(tile0 + g) + dy * ntx + dx;
    key = (tile << rank_bits) | __ldg(rank + g);
    if (valid && cull != nullptr) {
      const float* r = cull + 6 * (size_t)g;
      const float tx = __fmul_rn((float)(tile % ntx), (float)ts);
      const float ty = __fmul_rn((float)(tile / ntx), (float)ts);
      const float ms = min_sigma_rect(r[0], r[1], r[2], r[3], r[4], tx,
                                      __fadd_rn(tx, (float)ts), ty,
                                      __fadd_rn(ty, (float)ts));
      valid = ms <= r[5];
    }
  }
  key_out[s] = valid ? key : (num_tiles << rank_bits);
  gid_out[s] = valid ? g : 0;
}

}  // namespace

extern "C" int decode_bin_keys(const void* offsets, const void* ends,
                               const void* ncols, const void* tile0,
                               const void* rank, const void* cull, int n,
                               int m_cap, int ntx, int ts, int rank_bits,
                               int num_tiles, int use_cull, void* key,
                               void* gid, void* stream) {
  const int blocks = (m_cap + kThreads - 1) / kThreads;
  decode_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), static_cast<const int*>(ends),
      static_cast<const int*>(ncols), static_cast<const int*>(tile0),
      static_cast<const int*>(rank),
      use_cull ? static_cast<const float*>(cull) : nullptr, n, m_cap, ntx,
      ts, rank_bits, num_tiles, static_cast<int*>(key),
      static_cast<int*>(gid));
  return static_cast<int>(cudaGetLastError());
}
