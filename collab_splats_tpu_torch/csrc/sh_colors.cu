// Spherical-harmonic colours of Gaussian splats (degrees 1-3), forward and
// backward.
//
// Replaces no Pallas kernel: the JAX package leaves core/sh.py::eval_sh to
// XLA, which fuses the basis, the degree mask, the contraction with the
// coefficients, the +0.5 shift and the clamp into one pass.  The port ran
// them as plain PyTorch autograd: a torch.cat of features_dc and
// features_rest into an [N, K, 3] tensor, some twenty elementwise kernels
// for the direction, its normalisation and the basis, and the einsum
// "nk,nkc->nc" as [N, 1, K] x [N, K, 3] batched GEMMs, and in the backward
// two more batched products (GEMM and GEMV) and as many elementwise kernels
// again, over every row of the Gaussian table (2,524,288 at the bench
// scene).  These kernels compute
//   colour = clamp(eval_sh(cat(dc, rest), means - centre, degree) + 0.5, 0)
// and its gradient with respect to features_dc, features_rest and means,
// one thread per row with every intermediate in registers.
//
// Bound on the H100: bytes.  At K = 16 bases the forward reads 48 floats
// of coefficients and 3 of means and writes 3 (216 bytes a row); the
// backward reads the colour's cotangent, means, dc and rest and writes the
// gradients of dc, rest and means (420 bytes a row).  About 150 float
// operations a row forward and 400 backward are far below the card's
// float32 rate.
//
// Design.  features_rest, 180 of the 216 bytes at K = 16, is an [N, K-1, 3]
// row-major array: one thread's row is 180 bytes from its neighbour's, so
// loading it thread by thread would touch a new sector with every lane.
// Each block of kRows rows (a multiple of 4, so its rest span starts 16
// bytes aligned) stages its contiguous rest span into shared memory with
// 16-byte loads, neighbouring threads on neighbouring addresses, and each
// thread then reads its own row from there; a row's stride in shared
// memory is odd, so the 32 lanes of a warp fall in 32 banks.  The backward
// recomputes the direction, the basis and the raw colour instead of
// keeping them, writes its gradient of rest into the same shared rows in
// place, and stores the span with 16-byte stores straight into the
// leaf's [N, K-1, 3] layout: no cat is read or written either way.  dc,
// means and the colours (12 bytes a row each) are read and written by
// each thread directly, in warp-contiguous spans.  The clamp passes the
// gradient where raw + 0.5 >= 0, as torch.clamp's backward does; bases of
// degree above the active one contribute 0 * coefficient to the colour,
// as the plain version's masked einsum does, and take exact zero
// gradients.  The direction's gradient goes through its normalisation
// sqrt(|d|^2 + 1e-12).  No atomics: each thread writes its own row (the
// camera centre's gradient, -sum of the means', is a torch sum in the
// wrapper).  Float32 throughout, without fast math.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;  // rows (one thread each) a block; a multiple of 4

constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
constexpr float kC20 = 1.0925484305920792f, kC21 = -1.0925484305920792f,
                kC22 = 0.31539156525252005f, kC23 = -1.0925484305920792f,
                kC24 = 0.5462742152960396f;
constexpr float kC30 = -0.5900435899266435f, kC31 = 2.890611442640554f,
                kC32 = -0.4570457994644658f, kC33 = 0.3731763325901154f,
                kC34 = -0.4570457994644658f, kC35 = 1.445305721320277f,
                kC36 = -0.5900435899266435f;

// features_rest's floats a row, and a row's stride in shared memory (odd).
template <int K>
struct Rest {
  static constexpr int S = 3 * (K - 1);
  static constexpr int P = S | 1;
};

// Float f of the block's rest span, as its place in shared memory.
template <int K>
__device__ __forceinline__ int smem_index(int f) {
  return (f / Rest<K>::S) * Rest<K>::P + f % Rest<K>::S;
}

// Rows [row0, row0 + rows) of rest into shared memory: 16-byte loads over
// the span's whole quads, single floats over the rest of the last block's.
template <int K>
__device__ __forceinline__ void stage_in(const float* __restrict__ rest,
                                         long long row0, int rows,
                                         float* sm) {
  const float* src = rest + row0 * Rest<K>::S;
  const int total = rows * Rest<K>::S;
  const int quads = total / 4;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    const float4 v = __ldg(src4 + q);
    sm[smem_index<K>(4 * q)] = v.x;
    sm[smem_index<K>(4 * q + 1)] = v.y;
    sm[smem_index<K>(4 * q + 2)] = v.z;
    sm[smem_index<K>(4 * q + 3)] = v.w;
  }
  for (int f = 4 * quads + threadIdx.x; f < total; f += blockDim.x)
    sm[smem_index<K>(f)] = __ldg(src + f);
}

// The inverse of stage_in, into g_rest.
template <int K>
__device__ __forceinline__ void stage_out(const float* sm, long long row0,
                                          int rows,
                                          float* __restrict__ g_rest) {
  float* dst = g_rest + row0 * Rest<K>::S;
  const int total = rows * Rest<K>::S;
  const int quads = total / 4;
  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    dst4[q] = make_float4(sm[smem_index<K>(4 * q)],
                          sm[smem_index<K>(4 * q + 1)],
                          sm[smem_index<K>(4 * q + 2)],
                          sm[smem_index<K>(4 * q + 3)]);
  }
  for (int f = 4 * quads + threadIdx.x; f < total; f += blockDim.x)
    dst[f] = sm[smem_index<K>(f)];
}

// One row's direction from the camera centre, its length and the unit
// direction, as core/sh.py::eval_sh computes them.
struct Dir {
  float d[3];
  float norm;
  float u[3];
};

__device__ __forceinline__ Dir direction(const float* __restrict__ means,
                                         const float* __restrict__ centre,
                                         int centre_stride, long long i) {
  Dir r;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    r.d[c] = means[3 * i + c] - __ldg(centre + c * centre_stride);
  r.norm = sqrtf(r.d[0] * r.d[0] + r.d[1] * r.d[1] + r.d[2] * r.d[2] +
                 1e-12f);
#pragma unroll
  for (int c = 0; c < 3; ++c) r.u[c] = r.d[c] / r.norm;
  return r;
}

// The K basis values at the unit direction u, 0 from base `active` on.
template <int K>
__device__ __forceinline__ void basis(const float* u, int active,
                                      float* b) {
  const float x = u[0], y = u[1], z = u[2];
  b[0] = kC0;
  if constexpr (K > 1) {
    b[1] = -kC1 * y;
    b[2] = kC1 * z;
    b[3] = -kC1 * x;
  }
  if constexpr (K > 4) {
    const float xx = x * x, yy = y * y, zz = z * z;
    b[4] = kC20 * (x * y);
    b[5] = kC21 * (y * z);
    b[6] = kC22 * (2.0f * zz - xx - yy);
    b[7] = kC23 * (x * z);
    b[8] = kC24 * (xx - yy);
  }
  if constexpr (K > 9) {
    const float xx = x * x, yy = y * y, zz = z * z;
    b[9] = kC30 * y * (3.0f * xx - yy);
    b[10] = kC31 * x * y * z;
    b[11] = kC32 * y * (4.0f * zz - xx - yy);
    b[12] = kC33 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
    b[13] = kC34 * x * (4.0f * zz - xx - yy);
    b[14] = kC35 * z * (xx - yy);
    b[15] = kC36 * x * (xx - 3.0f * yy);
  }
#pragma unroll
  for (int k = 1; k < K; ++k)
    if (k >= active) b[k] = 0.0f;
}

// The raw colour (no shift, no clamp): the bases times dc and the thread's
// rest row in shared memory, in base order.
template <int K>
__device__ __forceinline__ void raw_colour(const float* b,
                                           const float* __restrict__ dc,
                                           const float* row, long long i,
                                           float* raw) {
#pragma unroll
  for (int c = 0; c < 3; ++c) raw[c] = b[0] * dc[3 * i + c];
#pragma unroll
  for (int k = 1; k < K; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      raw[c] = fmaf(b[k], row[3 * (k - 1) + c], raw[c]);
}

// The gradient at the unit direction of the bases' gradients gb (0 at the
// inactive ones), band by band.
template <int K>
__device__ __forceinline__ void basis_backward(const float* u,
                                               const float* gb, float* gu) {
  const float x = u[0], y = u[1], z = u[2];
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  if constexpr (K > 1) {
    gx -= kC1 * gb[3];
    gy -= kC1 * gb[1];
    gz += kC1 * gb[2];
  }
  if constexpr (K > 4) {
    gx += kC20 * y * gb[4] - 2.0f * kC22 * x * gb[6] + kC23 * z * gb[7] +
          2.0f * kC24 * x * gb[8];
    gy += kC20 * x * gb[4] + kC21 * z * gb[5] - 2.0f * kC22 * y * gb[6] -
          2.0f * kC24 * y * gb[8];
    gz += kC21 * y * gb[5] + 4.0f * kC22 * z * gb[6] + kC23 * x * gb[7];
  }
  if constexpr (K > 9) {
    const float xx = x * x, yy = y * y, zz = z * z;
    gx += 6.0f * kC30 * x * y * gb[9] + kC31 * y * z * gb[10] -
          2.0f * kC32 * x * y * gb[11] - 6.0f * kC33 * x * z * gb[12] +
          kC34 * (4.0f * zz - 3.0f * xx - yy) * gb[13] +
          2.0f * kC35 * x * z * gb[14] +
          kC36 * (3.0f * xx - 3.0f * yy) * gb[15];
    gy += kC30 * (3.0f * xx - 3.0f * yy) * gb[9] + kC31 * x * z * gb[10] +
          kC32 * (4.0f * zz - xx - 3.0f * yy) * gb[11] -
          6.0f * kC33 * y * z * gb[12] - 2.0f * kC34 * x * y * gb[13] -
          2.0f * kC35 * y * z * gb[14] - 6.0f * kC36 * x * y * gb[15];
    gz += kC31 * x * y * gb[10] + 8.0f * kC32 * y * z * gb[11] +
          kC33 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * gb[12] +
          8.0f * kC34 * x * z * gb[13] + kC35 * (xx - yy) * gb[14];
  }
  gu[0] = gx;
  gu[1] = gy;
  gu[2] = gz;
}

template <int K>
__global__ void __launch_bounds__(kRows)
    sh_fwd_kernel(const float* __restrict__ dc,
                  const float* __restrict__ rest,
                  const float* __restrict__ means,
                  const float* __restrict__ centre, int centre_stride, int n,
                  int active, float* __restrict__ out) {
  __shared__ float sm[kRows * Rest<K>::P];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = min(static_cast<long long>(kRows), n - row0);
  stage_in<K>(rest, row0, rows, sm);
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= rows) return;
  const long long i = row0 + t;
  const Dir dir = direction(means, centre, centre_stride, i);
  float b[K], raw[3];
  basis<K>(dir.u, active, b);
  raw_colour<K>(b, dc, sm + t * Rest<K>::P, i, raw);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = raw[c] + 0.5f;
    out[3 * i + c] = v < 0.0f ? 0.0f : v;  // a NaN stays, as in torch.clamp
  }
}

// g: the colours' cotangent, row stride g_stride.  g_dc, g_rest and
// g_means may each be null (not asked for).
template <int K>
__global__ void __launch_bounds__(kRows)
    sh_bwd_kernel(const float* __restrict__ dc,
                  const float* __restrict__ rest,
                  const float* __restrict__ means,
                  const float* __restrict__ centre, int centre_stride, int n,
                  int active, const float* __restrict__ g,
                  long long g_stride, float* __restrict__ g_dc,
                  float* __restrict__ g_rest, float* __restrict__ g_means) {
  __shared__ float sm[kRows * Rest<K>::P];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = min(static_cast<long long>(kRows), n - row0);
  stage_in<K>(rest, row0, rows, sm);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < rows) {
    const long long i = row0 + t;
    float* row = sm + t * Rest<K>::P;
    const Dir dir = direction(means, centre, centre_stride, i);
    float b[K], raw[3], gr[3];
    basis<K>(dir.u, active, b);
    raw_colour<K>(b, dc, row, i, raw);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      gr[c] = raw[c] + 0.5f >= 0.0f ? g[g_stride * i + c] : 0.0f;
    if (g_dc != nullptr) {
#pragma unroll
      for (int c = 0; c < 3; ++c) g_dc[3 * i + c] = b[0] * gr[c];
    }
    if (g_means != nullptr) {
      float gb[K], gu[3];  // gb[0], the constant base's, is not read
#pragma unroll
      for (int k = 1; k < K; ++k) {
        const float* ck = row + 3 * (k - 1);
        gb[k] = k < active ? ck[0] * gr[0] + ck[1] * gr[1] + ck[2] * gr[2]
                           : 0.0f;
      }
      basis_backward<K>(dir.u, gb, gu);
      const float dot = gu[0] * dir.u[0] + gu[1] * dir.u[1] + gu[2] * dir.u[2];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        g_means[3 * i + c] = (gu[c] - dir.u[c] * dot) / dir.norm;
    }
    if (g_rest != nullptr) {
      // In place: the thread's own row, after its last read of it.
#pragma unroll
      for (int k = 1; k < K; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          row[3 * (k - 1) + c] = k < active ? b[k] * gr[c] : 0.0f;
    }
  }
  if (g_rest != nullptr) {
    __syncthreads();
    stage_out<K>(sm, row0, rows, g_rest);
  }
}

int blocks(int n) { return (n + kRows - 1) / kRows; }

template <int K>
void launch_fwd(const float* dc, const float* rest, const float* means,
                const float* centre, int centre_stride, int n, int active,
                float* out, cudaStream_t st) {
  sh_fwd_kernel<K><<<blocks(n), kRows, 0, st>>>(
      dc, rest, means, centre, centre_stride, n, active, out);
}

template <int K>
void launch_bwd(const float* dc, const float* rest, const float* means,
                const float* centre, int centre_stride, int n, int active,
                const float* g, long long g_stride, float* g_dc,
                float* g_rest, float* g_means, cudaStream_t st) {
  sh_bwd_kernel<K><<<blocks(n), kRows, 0, st>>>(
      dc, rest, means, centre, centre_stride, n, active, g, g_stride, g_dc,
      g_rest, g_means);
}

}  // namespace

// k: bases a row (4, 9 or 16; features_rest is [n, k - 1, 3]); active: the
// bases of degree <= the active degree, min((degree + 1)^2, k).  rest must
// be 16-byte aligned.  Returns cudaErrorInvalidValue for another k.
extern "C" int sh_fwd(const void* dc, const void* rest, const void* means,
                      const void* centre, int centre_stride, int n, int k,
                      int active, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* o = static_cast<float*>(out);
  switch (k) {
    case 4:
      launch_fwd<4>(f(dc), f(rest), f(means), f(centre), centre_stride, n,
                    active, o, st);
      break;
    case 9:
      launch_fwd<9>(f(dc), f(rest), f(means), f(centre), centre_stride, n,
                    active, o, st);
      break;
    case 16:
      launch_fwd<16>(f(dc), f(rest), f(means), f(centre), centre_stride, n,
                     active, o, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// g: the colours' cotangent [n, 3] with row stride g_stride (columns
// contiguous); g_dc, g_rest and g_means may each be null; g_rest, when
// given, must be 16-byte aligned.
extern "C" int sh_bwd(const void* dc, const void* rest, const void* means,
                      const void* centre, int centre_stride, int n, int k,
                      int active, const void* g, long long g_stride,
                      void* g_dc, void* g_rest, void* g_means, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  switch (k) {
    case 4:
      launch_bwd<4>(f(dc), f(rest), f(means), f(centre), centre_stride, n,
                    active, f(g), g_stride, w(g_dc), w(g_rest), w(g_means),
                    st);
      break;
    case 9:
      launch_bwd<9>(f(dc), f(rest), f(means), f(centre), centre_stride, n,
                    active, f(g), g_stride, w(g_dc), w(g_rest), w(g_means),
                    st);
      break;
    case 16:
      launch_bwd<16>(f(dc), f(rest), f(means), f(centre), centre_stride, n,
                     active, f(g), g_stride, w(g_dc), w(g_rest), w(g_means),
                     st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
