// Binning decode: intersection-buffer slot -> (sort key, gaussian id).
//
// Replaces the Pallas kernel collab_splats_tpu/ops/pallas/binning_kernel.py
// ::decode_bin_keys (called from ops/tiles.py::_decode_keys_pallas).  Slot s
// of the [m_cap] buffer belongs to the gaussian g with
// offsets[g] <= s < ends[g] = offsets[g] + counts[g] (the runs laid end to
// end, so ends[] does not decrease); it gets key = tile << rank_bits |
// rank[g] and gid = g, where tile walks g's tile bbox row-major.  With the
// ellipse cull, a slot whose tile rectangle lies wholly outside the
// splat's alpha >= 1/255 ellipse (min over the rect of sigma >
// log(opac/cutoff)) is invalid.  Invalid slots, and slots past the
// buffer's live total, get the sentinel key num_tiles << rank_bits and
// gid 0.
//
// Bound on the H100: bytes written.  The work per slot is a handful of
// integer and float operations; the output is 8 bytes per slot (16 MB at
// 2^21 slots), read once by the key sort that follows.  What held the
// first version back was latency: a 20-step dependent binary search over
// ends[] per slot, to find an owner its neighbours share.
//
// Design: a merge path (segsum_kernel.cu's).  The owner of slot s is the
// number of run ends <= s, so the owners are the merge of ends[] with the
// slots 0..m_cap-1, an end taken before slot s iff it is <= s.  Each block
// owns kTileItems elements of the merged sequence.  Half of its threads
// find where its stretch begins among the ends and the other half where
// it ends, each half by a 128-ary search over the diagonal: a round probes
// 128 evenly spaced ends at once and keeps the stretch between the last
// probe before the crossing and the first after it, so three rounds of one
// load each (at a million gaussians) replace a binary search's 20
// dependent loads.  The block copies those ends to shared memory, and each
// thread finds its kItems elements there and walks them, recording each
// slot's owner in shared memory.  So no thread takes more than kItems
// steps, whatever the skew: a run of 10^5 zero-count gaussians or one
// gaussian owning more slots than a block.  Then the block's slots,
// consecutive, are decoded by consecutive threads and written out
// coalesced; a slot's owner fields (offset, bbox width, first tile, rank
// and the six cull columns) come through the read-only cache, where a
// warp's slots mostly share one owner and so one load.  (Staging each
// owner's fields in shared memory first measured slower on the H100: one
// more dependent phase, and 45 KB of shared memory a block, which left
// five blocks on an SM.)  The run ends are formed from the offsets and
// counts where they are read.  All integer fields are int32: the TPU
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
constexpr int kItems = 4;        // merged elements a thread walks
constexpr int kTileItems = kThreads * kItems;  // ... and a block
constexpr int kHalf = kThreads / 2;  // threads searching one diagonal
constexpr int kWarps = kThreads / 32;
constexpr int kCull = 6;         // cull columns per gaussian

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

// ends[i]: where gaussian i's run of slots ends.
__device__ __forceinline__ int run_end(const int* __restrict__ offsets,
                                       const int* __restrict__ counts,
                                       int i) {
  return __ldg(offsets + i) + __ldg(counts + i);
}

// How many of the run ends of gaussians [0, n) are among the first d
// elements of their merge with the slots 0..m-1, an end taken before slot
// s iff it is <= s: the first i with ends[i] > d - 1 - i (the merge path
// on diagonal d), for d = d0 in the block's first half of threads and
// d = d1 in its second.  Called by the whole block; every thread of a half
// returns its half's answer.
__device__ int merge_path_block(const int* __restrict__ offsets,
                                const int* __restrict__ counts, int n, int m,
                                int d0, int d1, int* votes) {
  const int half = threadIdx.x / kHalf;
  const int t = threadIdx.x % kHalf;
  const int d = half ? d1 : d0;
  // The answer lies in [lo, hi]; the predicate ends[i] <= d - 1 - i holds
  // exactly below it.
  int lo = max(0, d - m);
  int hi = min(d, n);
  for (;;) {
    const int span = hi - lo;
    const int step = (span + kHalf - 1) / kHalf;
    const int i = lo + t * step;
    const bool below =
        span > 0 && i < hi && run_end(offsets, counts, i) <= d - 1 - i;
    const unsigned ballot = __ballot_sync(0xffffffffu, below);
    if ((threadIdx.x & 31) == 0) votes[threadIdx.x / 32] = __popc(ballot);
    __syncthreads();
    // The predicate holds at probes 0 .. cnt - 1 and at none after.
    int cnt = 0;
#pragma unroll
    for (int w = 0; w < kWarps / 2; ++w) cnt += votes[half * kWarps / 2 + w];
    if (span > 0) {
      if (cnt == 0) {
        hi = lo;
      } else {
        const int last = lo + (cnt - 1) * step;
        lo = last + 1;
        hi = min(hi, last + step);
      }
    }
    if (__syncthreads_and(lo >= hi)) return lo;  // also frees votes
  }
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const int* __restrict__ offsets, const int* __restrict__ counts,
              const int* __restrict__ ncols, const int* __restrict__ tile0,
              const int* __restrict__ rank, const float* __restrict__ cull,
              int n, int m_cap, int ntx, int ts, int rank_bits,
              int num_tiles, int* __restrict__ key_out,
              int* __restrict__ gid_out) {
  __shared__ int ends[kTileItems];  // the stretch's run ends
  __shared__ int own[kTileItems];   // own[k]: the owner of the block's slot k
  __shared__ int bounds[2];
  __shared__ int votes[kWarps];

  const long long total = (long long)n + m_cap;
  const int d0 = (int)((long long)blockIdx.x * kTileItems);
  const int d1 = (int)min((long long)d0 + kTileItems, total);
  const int split = merge_path_block(offsets, counts, n, m_cap, d0, d1,
                                     votes);
  if (threadIdx.x % kHalf == 0) bounds[threadIdx.x / kHalf] = split;
  __syncthreads();
  const int a0 = bounds[0];
  const int na = bounds[1] - a0;   // ends a0 .. a0 + na - 1 ...
  const int q0 = d0 - a0;          // ... and slots q0 .. q0 + nq - 1
  const int nq = d1 - d0 - na;
  for (int t = threadIdx.x; t < na; t += kThreads)
    ends[t] = run_end(offsets, counts, a0 + t);
  __syncthreads();
  const int dl = threadIdx.x * kItems;
  if (dl < na + nq) {
    int lo = max(0, dl - nq);
    int hi = min(dl, na);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ends[mid] <= q0 + dl - 1 - mid) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int i = lo, q = dl - lo;
    const int end = min(dl + kItems, na + nq);
    for (int k = dl; k < end; ++k) {
      if (i < na && (q >= nq || ends[i] <= q0 + q)) {
        ++i;
      } else {
        own[q++] = a0 + i;
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nq; k += kThreads) {
    const int s = q0 + k;
    const int g = own[k];
    bool valid = g < n;
    int key = 0;
    if (valid) {
      const int off = __ldg(offsets + g);
      valid = off <= s;
      const int local = s - off;
      const int nc = __ldg(ncols + g);
      const int dy = local / nc;
      const int dx = local - dy * nc;
      const int t = __ldg(tile0 + g) + dy * ntx + dx;
      key = (t << rank_bits) | __ldg(rank + g);
      if (valid && cull != nullptr) {
        const float* r = cull + kCull * (size_t)g;
        const float tx = __fmul_rn((float)(t % ntx), (float)ts);
        const float ty = __fmul_rn((float)(t / ntx), (float)ts);
        const float ms = min_sigma_rect(
            __ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3), __ldg(r + 4),
            tx, __fadd_rn(tx, (float)ts), ty, __fadd_rn(ty, (float)ts));
        valid = ms <= __ldg(r + 5);
      }
    }
    key_out[s] = valid ? key : (num_tiles << rank_bits);
    gid_out[s] = valid ? g : 0;
  }
}

}  // namespace

extern "C" int decode_bin_keys(const void* offsets, const void* counts,
                               const void* ncols, const void* tile0,
                               const void* rank, const void* cull, int n,
                               int m_cap, int ntx, int ts, int rank_bits,
                               int num_tiles, int use_cull, void* key,
                               void* gid, void* stream) {
  const long long merged = (long long)n + m_cap;
  const int blocks = (int)((merged + kTileItems - 1) / kTileItems);
  decode_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), static_cast<const int*>(counts),
      static_cast<const int*>(ncols), static_cast<const int*>(tile0),
      static_cast<const int*>(rank),
      use_cull ? static_cast<const float*>(cull) : nullptr, n, m_cap, ntx,
      ts, rank_bits, num_tiles, static_cast<int*>(key),
      static_cast<int*>(gid));
  return static_cast<int>(cudaGetLastError());
}
