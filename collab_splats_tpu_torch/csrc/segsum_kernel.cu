// Sorted segment sum: exact per-gaussian sums of gid-sorted cotangent rows.
//
// Replaces the Pallas kernel collab_splats_tpu/ops/pallas/segsum_kernel.py::
// segment_sum_sorted (reached through expand_bwd_pallas), the backward of
// the intersection gather ops/segsum.py::expand_rows, and serves the
// absgrad statistic of train/strategy.py::update_state as well.  Given the
// ids sorted ascending (a stable sort, outside the kernel, as in the JAX
// package) and the sort's permutation, out[g, c] = sum of rows[order[i], c]
// over the i with sorted_ids[i] == g, summed in sorted order; 0 for a
// gaussian that owns no row.
//
// Bound on the H100: bytes -- each cotangent row, id and permutation entry
// is read once and each output row written once; there is one add per
// input element.
//
// Design: a group of L lanes (L a power of two, L >= D up to 32) per output
// gaussian.  Each lane finds the gaussian's segment with two binary searches
// over the sorted ids (the lanes of a group read the same addresses, as one
// broadcast), then sums its columns of the segment's rows in sorted order.
// Every output element is written by exactly one thread, as one sequential
// sum: no float atomics, and the same bits on every run.  The sums are
// exact float32 sums of the rows, not differences of running prefixes.

#include <cuda_runtime.h>

namespace {

// First position in sorted[0, m) whose value is >= key.
__device__ int lower_bound(const int* __restrict__ sorted, int m, int key) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (sorted[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void segsum_kernel(const int* __restrict__ sorted_ids,
                              const long long* __restrict__ order,
                              const float* __restrict__ rows, int m, int n,
                              int d, int lanes, float* __restrict__ out) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int gid = (int)(tid / lanes);
  const int lane = (int)(tid % lanes);
  if (gid >= n) return;
  const int lo = lower_bound(sorted_ids, m, gid);
  const int hi = lo + lower_bound(sorted_ids + lo, m - lo, gid + 1);
  for (int c = lane; c < d; c += lanes) {
    float acc = 0.f;
    for (int i = lo; i < hi; ++i) acc += rows[order[i] * d + c];
    out[(size_t)gid * d + c] = acc;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch; -1 for bad lane counts.
extern "C" int segment_sum_sorted(const void* sorted_ids, const void* order,
                                  const void* rows, int m, int n, int d,
                                  int lanes, void* out, void* stream) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0) return -1;
  constexpr int kThreads = 256;
  const long long threads = (long long)n * lanes;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  segsum_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sorted_ids),
      static_cast<const long long*>(order), static_cast<const float*>(rows),
      m, n, d, lanes, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
