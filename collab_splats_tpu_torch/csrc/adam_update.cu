// The train step's update: the finite guard over every gradient, then Adam
// over every parameter group with the dead-row mask, one launch each.
//
// Replaces no Pallas kernel: the JAX package leaves optax's per-group Adam
// and its guard to XLA, which fuses them.  The port ran them as plain
// PyTorch: per Gaussian group a multiply by the broadcast alive mask and an
// isfinite that wrote a bool tensor, a stack and two all(), then
// torch.optim.Adam's foreach chain per group (lerp, mul, addcmul, sqrt,
// div, add, addcdiv), each op one pass over every element of the group:
// 148.9M elements a step at the bench scene (59 floats a row over
// 2,524,288 rows) and about 72 bytes an element.
//
// Bound on the H100: bytes.  The guard reads each gradient once (4 bytes an
// element); the update reads p, g, m and v and writes p, m and v (28 bytes
// an element) and the alive byte of each row.  A dozen float operations an
// element are far below the card's float32 rate.
//
// Design.  Each launch walks one table of tensors, passed by value as a
// __grid_constant__ parameter (no copy to the card), as one flat run of
// float4 units, group after group, in a grid-stride loop over as many
// blocks as the card holds at once; a thread keeps a cursor into the
// table, which only moves forward.  A group whose four pointers are
// 16-byte aligned runs as float4 loads and stores, and its last n % 4
// elements, like every element of an unaligned group, in a second flat run
// of single floats.  The
// update finds each element's row by one division a float4 and a carry,
// and zeroes the gradient of a dead row in registers; a group without rows
// (a camera or decoder tensor) has width 0 and is not masked.  The guard
// keeps the largest exponent field it saw, and a block that saw an inf or
// a NaN writes false to the flag, which the entry set to true: every
// writer writes the same value, so no atomics and no second pass.  The
// arithmetic is torch's foreach Adam op for op, in float32 with each
// rounding explicit (no fast math):
//   m <- fma(1 - b1, g - m, m)              torch.lerp at a weight < 0.5
//   v <- fma(1 - b2, g * g, v * b2)         mul_, then addcmul_
//   p <- fma(step, m / (sqrt(v) / sqrt(1 - b2^t) + eps), p)
// with step = -lr / (1 - b1^t).  Each thread writes its own elements; the
// result does not depend on the grid.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 32;   // update table entries a launch
constexpr int kMaxChecks = 64;   // guard table entries a launch

// One tensor of the update; the layout of ops/cuda/adam_update.py::_Group.
struct Group {
  float* p;
  const float* g;      // null: a zero gradient
  float* m;
  float* v;
  long long n;         // elements
  long long width;     // elements a row of the alive mask; 0: not masked
  float step;          // -lr / (1 - b1^t)
  float bc2_sqrt;      // sqrt(1 - b2^t)
  float eps;
  int pad;
};

// One tensor of the guard; the layout of ops/cuda/adam_update.py::_Check.
struct Check {
  const float* x;
  long long n;
};

// A table and the ends of its two flat runs: entry i's float4 units end at
// vend[i] and its single floats at send[i], both counted over the entries
// before it too; entry i's single floats start at element 4 * (its float4
// units).
template <typename Entry, int kMax>
struct Table {
  Entry e[kMax];
  long long vend[kMax];
  long long send[kMax];
  int count;
};

using UpdateTable = Table<Group, kMaxGroups>;
using CheckTable = Table<Check, kMaxChecks>;

struct Betas {
  float w1;   // 1 - b1
  float b2;
  float c2;   // 1 - b2
};

__device__ __forceinline__ void adam(float& p, float g, float& m, float& v,
                                     const Group& G, const Betas& b) {
  m = __fmaf_rn(b.w1, __fsub_rn(g, m), m);
  v = __fmaf_rn(b.c2, __fmul_rn(g, g), __fmul_rn(v, b.b2));
  const float den = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), G.bc2_sqrt), G.eps);
  p = __fmaf_rn(G.step, __fdiv_rn(m, den), p);
}

// e / w, in 32 bits where both fit.
__device__ __forceinline__ long long div_rows(long long e, long long w) {
  if ((e | w) >> 32) return e / w;
  return static_cast<long long>(static_cast<unsigned>(e) /
                                static_cast<unsigned>(w));
}

__device__ __forceinline__ float masked(float g, const unsigned char* alive,
                                        long long row) {
  return __ldg(alive + row) ? g : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
adam_update_kernel(const __grid_constant__ UpdateTable T,
                   const unsigned char* __restrict__ alive, Betas b) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const int last = T.count - 1;
  int i = 0;
  for (long long q = first; q < T.vend[last]; q += stride) {
    while (q >= T.vend[i]) ++i;
    const Group& G = T.e[i];
    const long long e0 = 4 * (q - (i ? T.vend[i - 1] : 0));
    float4 p = *reinterpret_cast<const float4*>(G.p + e0);
    float4 m = *reinterpret_cast<const float4*>(G.m + e0);
    float4 v = *reinterpret_cast<const float4*>(G.v + e0);
    float4 g = G.g ? __ldg(reinterpret_cast<const float4*>(G.g + e0))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (G.width) {
      long long row = div_rows(e0, G.width);
      long long col = e0 - row * G.width;
      g.x = masked(g.x, alive, row);
      if (++col == G.width) col = 0, ++row;
      g.y = masked(g.y, alive, row);
      if (++col == G.width) col = 0, ++row;
      g.z = masked(g.z, alive, row);
      if (++col == G.width) col = 0, ++row;
      g.w = masked(g.w, alive, row);
    }
    adam(p.x, g.x, m.x, v.x, G, b);
    adam(p.y, g.y, m.y, v.y, G, b);
    adam(p.z, g.z, m.z, v.z, G, b);
    adam(p.w, g.w, m.w, v.w, G, b);
    *reinterpret_cast<float4*>(G.p + e0) = p;
    *reinterpret_cast<float4*>(G.m + e0) = m;
    *reinterpret_cast<float4*>(G.v + e0) = v;
  }
  i = 0;
  for (long long s = first; s < T.send[last]; s += stride) {
    while (s >= T.send[i]) ++i;
    const Group& G = T.e[i];
    const long long e = 4 * (T.vend[i] - (i ? T.vend[i - 1] : 0)) +
                        (s - (i ? T.send[i - 1] : 0));
    float g = G.g ? __ldg(G.g + e) : 0.0f;
    if (G.width) g = masked(g, alive, div_rows(e, G.width));
    adam(G.p[e], g, G.m[e], G.v[e], G, b);
  }
}

__device__ __forceinline__ unsigned exponent(float x) {
  return __float_as_uint(x) & 0x7f800000u;
}

__global__ void __launch_bounds__(kThreads)
finite_kernel(const __grid_constant__ CheckTable T, bool* __restrict__ flag) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const int last = T.count - 1;
  unsigned top = 0;
  int i = 0;
  for (long long q = first; q < T.vend[last]; q += stride) {
    while (q >= T.vend[i]) ++i;
    const float4 x = __ldg(reinterpret_cast<const float4*>(
        T.e[i].x + 4 * (q - (i ? T.vend[i - 1] : 0))));
    top = max(top, max(max(exponent(x.x), exponent(x.y)),
                       max(exponent(x.z), exponent(x.w))));
  }
  i = 0;
  for (long long s = first; s < T.send[last]; s += stride) {
    while (s >= T.send[i]) ++i;
    const long long e = 4 * (T.vend[i] - (i ? T.vend[i - 1] : 0)) +
                        (s - (i ? T.send[i - 1] : 0));
    top = max(top, exponent(__ldg(T.e[i].x + e)));
  }
  if (__syncthreads_or(top == 0x7f800000u) && threadIdx.x == 0) *flag = false;
}

bool aligned(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// Fill in the ends of the table's two runs; units: the float4 units of
// entry i, or 0 where it runs as single floats.
template <typename T, typename Units>
long long ends(T& t, Units units) {
  long long v = 0, s = 0;
  for (int i = 0; i < t.count; ++i) {
    const long long u = units(t.e[i]);
    v += u;
    s += t.e[i].n - 4 * u;
    t.vend[i] = v;
    t.send[i] = s;
  }
  return v > s ? v : s;
}

// Blocks for ``work`` threads' worth of units: at most as many as the
// card holds at once, so that no block waits for a second wave.
template <typename Kernel>
int grid(Kernel kernel, long long work) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const long long most =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long need = (work + kThreads - 1) / kThreads;
  return static_cast<int>(need < most ? (need > 0 ? need : 1) : most);
}

}  // namespace

// groups: count (1 to 32) entries; each p, m and v is a contiguous float32
// tensor of n elements, g one too or null; alive: the [rows] bool mask that
// masked entries' rows index.  Updates p, m and v in place.  Returns
// cudaErrorInvalidValue for another count.
extern "C" int adam_update(const void* groups, int count, const void* alive,
                           float w1, float b2, float c2, void* stream) {
  if (count < 1 || count > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  UpdateTable t;
  t.count = count;
  const Group* src = static_cast<const Group*>(groups);
  for (int i = 0; i < count; ++i) t.e[i] = src[i];
  const long long work = ends(t, [](const Group& G) {
    const bool vec = aligned(G.p) && aligned(G.m) && aligned(G.v) &&
                     (G.g == nullptr || aligned(G.g));
    return vec ? G.n / 4 : 0LL;
  });
  adam_update_kernel<<<grid(adam_update_kernel, work), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const unsigned char*>(alive), Betas{w1, b2, c2});
  return static_cast<int>(cudaGetLastError());
}

// checks: count (1 to 64) contiguous float32 tensors.  flag: one bool on
// the card, set to true first; the kernel writes false there if any
// element is an inf or a NaN.
extern "C" int adam_finite(const void* checks, int count, void* flag,
                           void* stream) {
  if (count < 1 || count > kMaxChecks)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  CheckTable t;
  t.count = count;
  const Check* src = static_cast<const Check*>(checks);
  for (int i = 0; i < count; ++i) t.e[i] = src[i];
  const long long work = ends(t, [](const Check& c) {
    return aligned(c.x) ? c.n / 4 : 0LL;
  });
  cudaMemsetAsync(flag, 1, 1, st);
  finite_kernel<<<grid(finite_kernel, work), kThreads, 0, st>>>(
      t, static_cast<bool*>(flag));
  return static_cast<int>(cudaGetLastError());
}
