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
// input element.  What holds it back is latency: the average segment has
// fewer than two rows, so finding a gaussian's segment must cost no more
// than reading it (two binary searches over all M sorted ids are about 42
// dependent loads), and each group of lanes needs several reads in flight.
//
// Design, two launches on the caller's stream:
//  1. segment_starts_kernel: start[g] = the number of sorted ids below g,
//     for g in [0, n] (the JAX wrapper's searchsorted(sidx, edges, "left")),
//     as a merge of the sorted ids with the queries 0..n.  Each block owns
//     kTileItems elements of the merged sequence: two threads find where
//     its stretch begins and ends among the ids (the merge path, one binary
//     search each), the block copies those ids to shared memory, each
//     thread finds its kItems elements there and merges them, and the
//     block's starts, consecutive, are written out together.  The work is
//     O(M + N) and spread evenly whatever the ids: a run of 10^5 empty ids
//     or a segment of 10^5 rows costs no thread more than kItems steps
//     (filling the gaps from each id instead would leave a run of empty ids
//     to one thread).
//  2. segment_sums_kernel: a group of L lanes (L the power of two >= D, up
//     to 32), lane c summing column c, walks the rows of 16 consecutive
//     gaussians (4 where L < 16 and a warp holds 32 / L groups) in sorted
//     order, kUnroll rows per step: the step's permutation entries and row
//     values are all loaded before the first is added, so a group keeps
//     kUnroll reads in flight.  The block's sums are gathered in shared
//     memory and written out as one contiguous stretch of out.  A gaussian
//     longer than long_rows rows (the wrapper's 128) is left to its block:
//     after the walk all 256 threads stage its rows in shared memory, the
//     next stage's reads in flight while thread c adds column c of the
//     current one, so a gaussian that covers many tiles is read
//     kStageFloats values at a time, not kUnroll rows.  A group alone would
//     take its rows one dependent step of kUnroll after another: a
//     gaussian over all 3,600 tiles of a 1280x720 image would then set the
//     kernel's time.
// Every output element is one sequential float32 sum in sorted order,
// starting from 0 -- the plain version's order, so the result is the same
// bits as the plain segment_reduce, on every run.  Long segments are not
// split.  No atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;       // merged elements per thread in launch 1
constexpr int kTileItems = kThreads * kItems;  // ... and per block
constexpr int kUnroll = 8;       // rows a group loads before adding them
constexpr int kSumsBlocks = 4;   // blocks an SM holds of launch 2
constexpr int kStageFloats = 2048;  // shared-memory stage of the long path
constexpr int kFetch = kStageFloats / kThreads;  // a thread's share of it

// How many of the sorted ids a[0, m) are among the first d elements of
// their merge with the queries 0..n, an id taken before query g iff it is
// < g (the merge path's binary search on diagonal d).
__device__ int merge_path(const int* __restrict__ a, int m, int n, int d) {
  int lo = max(0, d - (n + 1));
  int hi = min(d, m);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < d - 1 - mid) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// start[g] for g in [0, n]: the merge, kTileItems elements per block.  Two
// threads find where the block's stretch begins and ends in a[]; the block
// copies those ids to shared memory; each thread finds its kItems elements
// there and merges them, writing start[g] for each query it passes.
__global__ void __launch_bounds__(kThreads)
segment_starts_kernel(const int* __restrict__ a, int m, int n,
                      int* __restrict__ start) {
  __shared__ int tile[kTileItems];     // the block's ids
  __shared__ int found[kTileItems];    // the block's starts
  __shared__ int bounds[2];
  const int total = m + n + 1;
  const int d0 = blockIdx.x * kTileItems;
  const int d1 = min(d0 + kTileItems, total);
  if (threadIdx.x < 2) bounds[threadIdx.x] = merge_path(a, m, n,
                                                        threadIdx.x ? d1 : d0);
  __syncthreads();
  const int a0 = bounds[0];
  const int na = bounds[1] - a0;       // ids a[a0, a0 + na) ...
  const int q0 = d0 - a0;              // ... and queries q0 .. q0 + nq - 1
  const int nq = d1 - d0 - na;
  for (int t = threadIdx.x; t < na; t += kThreads) tile[t] = a[a0 + t];
  __syncthreads();
  const int dl = threadIdx.x * kItems;
  if (dl < na + nq) {
    int lo = max(0, dl - nq);
    int hi = min(dl, na);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (tile[mid] < q0 + dl - 1 - mid) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int i = lo, q = dl - lo;
    const int end = min(dl + kItems, na + nq);
    for (int k = dl; k < end; ++k) {
      if (i < na && (q >= nq || tile[i] < q0 + q)) {
        ++i;
      } else {
        found[q++] = a0 + i;
      }
    }
  }
  __syncthreads();
  // The block's queries are consecutive: write their starts so.
  for (int t = threadIdx.x; t < nq; t += kThreads) start[q0 + t] = found[t];
}

// The lanes of a group, lane c summing column c (and c + L, ...), walk the
// rows of the group's kGroup consecutive gaussians in sorted order, kUnroll
// rows per step: the permutation entries and the row values of a step are
// loaded before any of them is added, then added one after another, each to
// the sum of the gaussian it belongs to.  Gaussians longer than long_rows
// rows are skipped here and summed by the whole block afterwards.
__global__ void __launch_bounds__(kThreads, kSumsBlocks)
segment_sums_kernel(const int* __restrict__ start,
                    const long long* __restrict__ order,
                    const float* __restrict__ rows, int n, int d, int lanes,
                    int group, int stage, int long_rows,
                    float* __restrict__ out) {
  extern __shared__ int smem[];
  const int per_block = kThreads / lanes * group;
  int* s = smem;                                   // [per_block + 1] starts
  float* sums = reinterpret_cast<float*>(s + per_block + 1);  // [per_block, d]
  float* staged = sums + per_block * d;            // [stage, d] long rows
  const int g0 = blockIdx.x * per_block;
  const int nloc = min(per_block, n - g0);
  for (int t = threadIdx.x; t <= nloc; t += kThreads) s[t] = start[g0 + t];
  __syncthreads();
  auto is_long = [&](int j) { return s[j + 1] - s[j] > long_rows; };

  const int ga = (int)(threadIdx.x / lanes) * group;
  const int gb = min(ga + group, nloc);
  for (int c = threadIdx.x % lanes; ga < gb && c < d; c += lanes) {
    int gq = ga;           // the open gaussian: rows [lo, hi)
    int lo = s[ga];
    int hi = s[ga + 1];
    int i = lo;
    const int iend = s[gb];
    float acc = 0.f;
    // Close gaussian gq (its sum, or 0 if it owns no row) and open the next.
    auto close = [&]() {
      if (hi - lo <= long_rows) sums[gq * d + c] = acc;
      acc = 0.f;
      lo = hi;
      if (++gq < gb) hi = s[gq + 1];
    };
    while (i < iend) {
      const int nk = min(kUnroll, iend - i);
      int o[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (k < nk) o[k] = (int)order[i + k];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (k < nk) v[k] = rows[o[k] * d + c];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (k < nk) {
          while (hi <= i + k) close();
          acc += v[k];
        }
      }
      i += nk;
      // Past the rest of a long gaussian without reading it.
      if (hi - lo > long_rows) i = max(i, hi);
    }
    while (gq < gb) close();
  }

  // The block's long gaussians, one after another.
  int any_long = 0;
  for (int j = threadIdx.x; j < nloc; j += kThreads) any_long |= is_long(j);
  const bool block_long = __syncthreads_or(any_long);
  const int width = min(d, kThreads);
  for (int j = 0; block_long && j < nloc; ++j) {
    if (!is_long(j)) continue;
    const int lo = s[j];
    const int hi = s[j + 1];
    for (int c0 = 0; c0 < d; c0 += width) {
      const int w = min(width, d - c0);
      // Each thread fetches up to kFetch elements of a stage into registers;
      // the next stage's are in flight while the current one is added.
      float buf[kFetch];
      auto fetch = [&](int base) {
        const int nr = min(stage, hi - base);
        int at[kFetch];  // all permutation entries first, then all values
#pragma unroll
        for (int u = 0; u < kFetch; ++u) {
          const int e = threadIdx.x + u * kThreads;
          const int r = e / w;
          at[u] = e < nr * w ? (int)order[base + r] * d + c0 + (e - r * w) : 0;
        }
#pragma unroll
        for (int u = 0; u < kFetch; ++u) {
          if ((int)threadIdx.x + u * kThreads < nr * w) buf[u] = rows[at[u]];
        }
      };
      fetch(lo);
      float acc = 0.f;
      for (int base = lo; base < hi; base += stage) {
        const int nr = min(stage, hi - base);
        __syncthreads();  // the previous stage is consumed
#pragma unroll
        for (int u = 0; u < kFetch; ++u) {
          const int e = threadIdx.x + u * kThreads;
          if (e < nr * w) staged[e] = buf[u];
        }
        __syncthreads();
        if (base + stage < hi) fetch(base + stage);
        if ((int)threadIdx.x < w) {
#pragma unroll 8
          for (int r = 0; r < nr; ++r) acc += staged[r * w + threadIdx.x];
        }
      }
      if ((int)threadIdx.x < w) sums[j * d + c0 + threadIdx.x] = acc;
    }
  }
  __syncthreads();
  // The block's rows of out are contiguous: write them so.
  for (int e = threadIdx.x; e < nloc * d; e += kThreads)
    out[(size_t)g0 * d + e] = sums[e];
}

}  // namespace

// Returns cudaGetLastError() after the launches; -1 for bad arguments.
// ``start`` is the caller's int32 scratch of n + 1 entries; segments longer
// than ``long_rows`` rows are summed by a whole block.
extern "C" int segment_sum_sorted(const void* sorted_ids, const void* order,
                                  const void* rows, int m, int n, int d,
                                  int lanes, int long_rows, void* start,
                                  void* out, void* stream) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 || d < 1 ||
      long_rows < 0)
    return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto* sp = static_cast<int*>(start);
  segment_starts_kernel<<<(int)(((long long)m + n + kTileItems) /
                                kTileItems),
                          kThreads, 0, st>>>(
      static_cast<const int*>(sorted_ids), m, n, sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int width = d < kThreads ? d : kThreads;
  const int stage = kStageFloats / width > 0 ? kStageFloats / width : 1;
  const int group = lanes >= 16 ? 16 : 4;
  const int per_block = kThreads / lanes * group;
  const int blocks = (n + per_block - 1) / per_block;
  const size_t smem = sizeof(int) * (size_t)(per_block + 1) +
                      sizeof(float) * ((size_t)per_block * d + stage * width);
  if (smem > 48 * 1024) {  // only wide rows need more than the default
    err = cudaFuncSetAttribute(segment_sums_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  segment_sums_kernel<<<blocks, kThreads, smem, st>>>(
      sp, static_cast<const long long*>(order),
      static_cast<const float*>(rows), n, d, lanes, group, stage, long_rows,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
