// EWA + RaDe-GS projection of 3D Gaussians into one camera, forward and
// backward.
//
// Replaces no Pallas kernel: the JAX package leaves core/projection.py::
// project_gaussians to XLA, which fuses its per-row arithmetic.  The port
// ran it as plain PyTorch autograd, about a hundred elementwise kernels and
// float32 batched 3x3 products over every row of the Gaussian table
// (2,524,288 at the bench scene), each writing its [N] or [N, 3, 3] result
// to device memory, and as many again in the backward.  These kernels
// compute the same function, and its gradient with respect to means, quats
// and scales, and, when the camera takes one (pose optimisation), to
// viewmat and K, one thread per row with every intermediate in registers.
//
// Bound on the H100: bytes.  The forward reads 11 floats a row (means,
// quats, scales, opacity) and writes 15 floats and a byte (the nine
// Projection fields); the backward reads the 10 input floats and the 12
// floats of the six cotangents and writes 10.  Some 300 float operations a
// row forward and 600 backward are far below the card's float32 rate.
//
// Design.  The forward's quantities are computed by row_forward, which both
// kernels call, with __fmul_rn / __fadd_rn / __fdiv_rn in the plain
// version's order (core/projection.py::_terms): nvcc contracts no FMA there,
// so the two kernels take the same decisions (the depth range, the det and
// compensation clamps, the facing flip) on the same bits, and the
// forward's ceil and valid tests round as PyTorch's elementwise kernels do
// (the 3x3 products and the camera transform are cuBLAS's in the plain
// version, and agree to rounding, not bit for bit).  The backward then
// runs reverse mode by hand in core/projection.py::project_backward's
// order: every where, clamp and + 1e-12 of the forward passes the gradient
// autograd passes (0 at the det and compensation clamps, 0 through the
// zs = 1 of rows outside the depth range), and nothing [N, 3, 3] is kept
// between the two launches.  The camera (viewmat, K) is read from device
// memory by every thread, through the read-only cache, so a launch reads
// nothing back to the host.  Cotangents are read through their row
// strides (the slices of the packed matrix's gradient arrive as strided
// views); an absent one is a null pointer and reads as 0.  No atomics:
// each thread writes its own row, and the camera's gradient, a sum over
// every row, is summed in a fixed order: each block's rows by warp
// shuffles and then warp by warp into one partial, and the partials by a
// second, one-block kernel, so a step repeats bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Rounded float32 operations that nvcc never fuses into an FMA.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
// torch.clamp(x, min=lo) and torch.minimum: a NaN propagates.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float minimum(float a, float b) {
  return (a < b || a != a) ? a : b;
}

struct Camera {
  float w[9];  // world-to-camera rotation, row-major
  float t[3];
  float fx, fy, cx, cy;
};

__device__ __forceinline__ Camera load_camera(const float* __restrict__ vm,
                                              const float* __restrict__ k) {
  Camera cam;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) cam.w[3 * i + j] = __ldg(vm + 4 * i + j);
    cam.t[i] = __ldg(vm + 4 * i + 3);
  }
  cam.fx = __ldg(k + 0);
  cam.fy = __ldg(k + 4);
  cam.cx = __ldg(k + 2);
  cam.cy = __ldg(k + 5);
  return cam;
}

// One row's forward quantities that the outputs or the backward read.
struct Row {
  float m[3];          // the centre in the world
  float q[4], q_len;   // the raw quaternion and sqrt(|q|^2 + 1e-12)
  float r[9];          // the rotation of q / q_len, row-major
  float s[3];          // linear scales
  float cw[9];         // Sigma_w = M M^T
  float cc[6];         // Sigma_c: 00, 01, 02, 11, 12, 22
  float x, y, z, zs, rz;
  bool in_depth;
  float j00, j02, j11, j12;
  float ju0, ju2, jv0, jv1, jv2;
  float a_raw, b_raw, c_raw, a, b, c, det, det_safe;
  bool ok_det;
  float ratio, comp;
  bool ratio_pos;
  float inv_det, k0, k1, k2;
  float u, v;
  float s_ut, s_vt, pu, pv;
  float nr[3], n_len;  // the normal before normalising, and its length
  bool flip;
  float n[3];          // the unit normal, facing the camera
};

__device__ __forceinline__ Row row_forward(const float* __restrict__ means,
                                           const float* __restrict__ quats,
                                           const float* __restrict__ scales,
                                           int i, const Camera& cam,
                                           float eps2d, float near_plane,
                                           float far_plane) {
  Row o;
#pragma unroll
  for (int k = 0; k < 3; ++k) o.m[k] = means[3 * i + k];
  const float m0 = o.m[0], m1 = o.m[1], m2 = o.m[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) o.q[k] = quats[4 * i + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) o.s[k] = scales[3 * i + k];

  // quat_to_rotmat.
  const float q01 = add_rn(mul_rn(o.q[0], o.q[0]), mul_rn(o.q[1], o.q[1]));
  const float q012 = add_rn(q01, mul_rn(o.q[2], o.q[2]));
  o.q_len = __fsqrt_rn(add_rn(add_rn(q012, mul_rn(o.q[3], o.q[3])), 1e-12f));
  const float w = div_rn(o.q[0], o.q_len), x = div_rn(o.q[1], o.q_len),
              y = div_rn(o.q[2], o.q_len), z = div_rn(o.q[3], o.q_len);
  o.r[0] = sub_rn(1.0f, mul_rn(2.0f, add_rn(mul_rn(y, y), mul_rn(z, z))));
  o.r[1] = mul_rn(2.0f, sub_rn(mul_rn(x, y), mul_rn(w, z)));
  o.r[2] = mul_rn(2.0f, add_rn(mul_rn(x, z), mul_rn(w, y)));
  o.r[3] = mul_rn(2.0f, add_rn(mul_rn(x, y), mul_rn(w, z)));
  o.r[4] = sub_rn(1.0f, mul_rn(2.0f, add_rn(mul_rn(x, x), mul_rn(z, z))));
  o.r[5] = mul_rn(2.0f, sub_rn(mul_rn(y, z), mul_rn(w, x)));
  o.r[6] = mul_rn(2.0f, sub_rn(mul_rn(x, z), mul_rn(w, y)));
  o.r[7] = mul_rn(2.0f, add_rn(mul_rn(y, z), mul_rn(w, x)));
  o.r[8] = sub_rn(1.0f, mul_rn(2.0f, add_rn(mul_rn(x, x), mul_rn(y, y))));

  // Sigma_w = M M^T with M = R diag(s), then Sigma_c = W Sigma_w W^T.
  float mm[9], tw[9];
  float* cw = o.cw;
#pragma unroll
  for (int k = 0; k < 9; ++k) mm[k] = mul_rn(o.r[k], o.s[k % 3]);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      cw[3 * a + b] = add_rn(add_rn(mul_rn(mm[3 * a], mm[3 * b]),
                                    mul_rn(mm[3 * a + 1], mm[3 * b + 1])),
                             mul_rn(mm[3 * a + 2], mm[3 * b + 2]));
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      tw[3 * a + b] = add_rn(add_rn(mul_rn(cam.w[3 * a], cw[b]),
                                    mul_rn(cam.w[3 * a + 1], cw[3 + b])),
                             mul_rn(cam.w[3 * a + 2], cw[6 + b]));
    }
  }
  const int upper[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int a = upper[k][0], b = upper[k][1];
    o.cc[k] = add_rn(add_rn(mul_rn(tw[3 * a], cam.w[3 * b]),
                            mul_rn(tw[3 * a + 1], cam.w[3 * b + 1])),
                     mul_rn(tw[3 * a + 2], cam.w[3 * b + 2]));
  }
  const float c00 = o.cc[0], c01 = o.cc[1], c02 = o.cc[2], c11 = o.cc[3],
              c12 = o.cc[4], c22 = o.cc[5];

  // The centre in the camera and the depth range.
  o.x = add_rn(add_rn(add_rn(mul_rn(cam.w[0], m0), mul_rn(cam.w[1], m1)),
                      mul_rn(cam.w[2], m2)),
               cam.t[0]);
  o.y = add_rn(add_rn(add_rn(mul_rn(cam.w[3], m0), mul_rn(cam.w[4], m1)),
                      mul_rn(cam.w[5], m2)),
               cam.t[1]);
  o.z = add_rn(add_rn(add_rn(mul_rn(cam.w[6], m0), mul_rn(cam.w[7], m1)),
                      mul_rn(cam.w[8], m2)),
               cam.t[2]);
  o.in_depth = (o.z > near_plane) && (o.z < far_plane);
  o.zs = o.in_depth ? o.z : 1.0f;

  o.rz = div_rn(1.0f, o.zs);
  const float rz2 = mul_rn(o.rz, o.rz);
  o.j00 = mul_rn(cam.fx, o.rz);
  o.j02 = mul_rn(mul_rn(-cam.fx, o.x), rz2);
  o.j11 = mul_rn(cam.fy, o.rz);
  o.j12 = mul_rn(mul_rn(-cam.fy, o.y), rz2);

  // Sigma2D = J Sigma_c J^T.
  o.ju0 = add_rn(mul_rn(o.j00, c00), mul_rn(o.j02, c02));
  o.ju2 = add_rn(mul_rn(o.j00, c02), mul_rn(o.j02, c22));
  o.jv0 = add_rn(mul_rn(o.j11, c01), mul_rn(o.j12, c02));
  o.jv1 = add_rn(mul_rn(o.j11, c11), mul_rn(o.j12, c12));
  o.jv2 = add_rn(mul_rn(o.j11, c12), mul_rn(o.j12, c22));
  o.a_raw = add_rn(mul_rn(o.ju0, o.j00), mul_rn(o.ju2, o.j02));
  o.b_raw = add_rn(mul_rn(o.jv0, o.j00), mul_rn(o.jv2, o.j02));
  o.c_raw = add_rn(mul_rn(o.jv1, o.j11), mul_rn(o.jv2, o.j12));

  const float det_raw =
      sub_rn(mul_rn(o.a_raw, o.c_raw), mul_rn(o.b_raw, o.b_raw));
  o.a = add_rn(o.a_raw, eps2d);
  o.c = add_rn(o.c_raw, eps2d);
  o.b = o.b_raw;
  o.det = sub_rn(mul_rn(o.a, o.c), mul_rn(o.b, o.b));
  o.ok_det = o.det > 1e-12f;
  o.det_safe = o.ok_det ? o.det : 1.0f;

  // Antialias compensation: sqrt of the ratio, 0 at and below the clamp.
  o.ratio = div_rn(det_raw, o.det_safe);
  o.ratio_pos = o.ratio > 1e-12f;
  o.comp = o.ratio_pos ? __fsqrt_rn(o.ratio) : 0.0f;

  o.inv_det = div_rn(1.0f, o.det_safe);
  o.k0 = mul_rn(o.c, o.inv_det);
  o.k1 = mul_rn(-o.b, o.inv_det);
  o.k2 = mul_rn(o.a, o.inv_det);
  o.u = add_rn(mul_rn(mul_rn(cam.fx, o.x), o.rz), cam.cx);
  o.v = add_rn(mul_rn(mul_rn(cam.fy, o.y), o.rz), cam.cy);

  // RaDe depth plane and the camera-facing normal of its surface.
  o.s_ut = add_rn(mul_rn(o.j00, c02), mul_rn(o.j02, c22));
  o.s_vt = add_rn(mul_rn(o.j11, c12), mul_rn(o.j12, c22));
  o.pu = add_rn(mul_rn(o.k0, o.s_ut), mul_rn(o.k1, o.s_vt));
  o.pv = add_rn(mul_rn(o.k1, o.s_ut), mul_rn(o.k2, o.s_vt));
  o.nr[0] = mul_rn(-o.pu, cam.fx);
  o.nr[1] = mul_rn(-o.pv, cam.fy);
  o.nr[2] = add_rn(add_rn(mul_rn(o.pu, sub_rn(o.u, cam.cx)),
                          mul_rn(o.pv, sub_rn(o.v, cam.cy))),
                   o.zs);
  const float n01 =
      add_rn(mul_rn(o.nr[0], o.nr[0]), mul_rn(o.nr[1], o.nr[1]));
  o.n_len =
      __fsqrt_rn(add_rn(add_rn(n01, mul_rn(o.nr[2], o.nr[2])), 1e-12f));
  float nu[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) nu[k] = div_rn(o.nr[k], o.n_len);
  const float facing =
      add_rn(add_rn(mul_rn(nu[0], o.x), mul_rn(nu[1], o.y)),
             mul_rn(nu[2], o.z));
  o.flip = facing > 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) o.n[k] = o.flip ? -nu[k] : nu[k];
  return o;
}

__global__ void __launch_bounds__(kThreads) project_fwd_kernel(
    const float* __restrict__ means, const float* __restrict__ quats,
    const float* __restrict__ scales, const float* __restrict__ opacities,
    const float* __restrict__ viewmat, const float* __restrict__ K, int n,
    float width, float height, float eps2d, float near_plane,
    float far_plane, float radius_clip, float* __restrict__ mean2d,
    float* __restrict__ depth, float* __restrict__ conic,
    float* __restrict__ radius, float* __restrict__ comp,
    float* __restrict__ plane, float* __restrict__ normal,
    bool* __restrict__ valid, float* __restrict__ radius_xy) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Camera cam = load_camera(viewmat, K);
  const Row o = row_forward(means, quats, scales, i, cam, eps2d, near_plane,
                            far_plane);

  // Square radius from the larger eigenvalue of the blurred covariance.
  const float mid = mul_rn(0.5f, add_rn(o.a, o.c));
  const float spread = clamp_min(sub_rn(mul_rn(mid, mid), o.det), 0.01f);
  const float eig_max = add_rn(mid, __fsqrt_rn(spread));
  const float rad = ceilf(mul_rn(3.0f, __fsqrt_rn(clamp_min(eig_max, 0.0f))));
  // Per-axis bbox of the alpha >= 1/255 ellipse, opacity-aware if given.
  float cut = 3.3291f;
  if (opacities != nullptr) {
    const float op = opacities[i];
    const float o01 = op < 0.0f ? 0.0f : (op > 1.0f ? 1.0f : op);
    cut = __fsqrt_rn(mul_rn(2.0f, clamp_min(logf(mul_rn(255.0f, o01)), 0.0f)));
  }
  const float rx =
      ceilf(minimum(mul_rn(cut, __fsqrt_rn(clamp_min(o.a, 0.0f))), rad));
  const float ry =
      ceilf(minimum(mul_rn(cut, __fsqrt_rn(clamp_min(o.c, 0.0f))), rad));
  const bool on_screen =
      add_rn(o.u, rad) > 0.0f && sub_rn(o.u, rad) < width &&
      add_rn(o.v, rad) > 0.0f && sub_rn(o.v, rad) < height;
  const bool ok = o.in_depth && o.ok_det && on_screen && rad > radius_clip;

  mean2d[2 * i] = o.u;
  mean2d[2 * i + 1] = o.v;
  depth[i] = o.z;
  conic[3 * i] = o.k0;
  conic[3 * i + 1] = o.k1;
  conic[3 * i + 2] = o.k2;
  radius[i] = ok ? rad : 0.0f;
  comp[i] = o.comp;
  plane[2 * i] = o.pu;
  plane[2 * i + 1] = o.pv;
#pragma unroll
  for (int k = 0; k < 3; ++k) normal[3 * i + k] = o.n[k];
  valid[i] = ok;
  radius_xy[2 * i] = ok ? rx : 0.0f;
  radius_xy[2 * i + 1] = ok ? ry : 0.0f;
}

// The six cotangents: a base pointer (null when the output takes none) and
// a row stride in floats each; columns are contiguous.
struct Cotangents {
  const float* p[6];  // mean2d, depth, conic, plane, normal, compensation
  long long stride[6];
};

__device__ __forceinline__ float cot(const Cotangents& g, int which, int i,
                                     int col) {
  const float* p = g.p[which];
  return p == nullptr ? 0.0f : p[g.stride[which] * i + col];
}

// The camera's gradient a row gives, in this order: d/dW (3x3 row-major),
// d/dt, d/dfx, d/dfy, d/dcx, d/dcy.
constexpr int kCamGrads = 16;

// Sums v over the block in a fixed order (warp shuffles, then the warps in
// turn) and writes the kN sums to out from the first kN threads.  Every
// thread of the block calls it.
template <int kN>
__device__ __forceinline__ void block_sum(float (&v)[kN],
                                          float* __restrict__ out) {
  __shared__ float warp_sums[kThreads / 32][kN];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    }
    if (lane == 0) warp_sums[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < kN) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += warp_sums[w][threadIdx.x];
    out[threadIdx.x] = sum;
  }
}

// One row's backward: writes its v_means, v_quats and v_scales and, when
// gcam is not null, its share of the camera's gradient into gcam.
__device__ __forceinline__ void row_backward(
    const float* __restrict__ means, const float* __restrict__ quats,
    const float* __restrict__ scales, int i, const Camera& cam, float eps2d,
    float near_plane, float far_plane, const Cotangents& g,
    float* __restrict__ v_means, float* __restrict__ v_quats,
    float* __restrict__ v_scales, float* gcam) {
  const Row o = row_forward(means, quats, scales, i, cam, eps2d, near_plane,
                            far_plane);
  const float fx = cam.fx, fy = cam.fy;

  // The normal: the facing flip, then n_raw / n_len.
  float gn[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float c = cot(g, 4, i, k);
    gn[k] = o.flip ? -c : c;
  }
  const float il = 1.0f / o.n_len;
  const float dot = gn[0] * o.nr[0] + gn[1] * o.nr[1] + gn[2] * o.nr[2];
  const float dil3 = dot * il * il * il;
  const float g_nr0 = gn[0] * il - o.nr[0] * dil3;
  const float g_nr1 = gn[1] * il - o.nr[1] * dil3;
  const float g_nr2 = gn[2] * il - o.nr[2] * dil3;
  // n_raw = (-pu fx, -pv fy, pu (u - cx) + pv (v - cy) + zs).
  const float g_pu = cot(g, 3, i, 0) - fx * g_nr0 + (o.u - cam.cx) * g_nr2;
  const float g_pv = cot(g, 3, i, 1) - fy * g_nr1 + (o.v - cam.cy) * g_nr2;
  const float g_u = cot(g, 0, i, 0) + o.pu * g_nr2;
  const float g_v = cot(g, 0, i, 1) + o.pv * g_nr2;
  float g_zs = g_nr2;
  // plane = conic (s_ut, s_vt).
  const float g_k0 = cot(g, 2, i, 0) + g_pu * o.s_ut;
  const float g_k1 = cot(g, 2, i, 1) + g_pu * o.s_vt + g_pv * o.s_ut;
  const float g_k2 = cot(g, 2, i, 2) + g_pv * o.s_vt;
  const float g_sut = g_pu * o.k0 + g_pv * o.k1;
  const float g_svt = g_pu * o.k1 + g_pv * o.k2;
  // conic = (c, -b, a) / det_safe.
  const float g_a = g_k2 * o.inv_det;
  const float g_b = -g_k1 * o.inv_det;
  const float g_c = g_k0 * o.inv_det;
  const float g_inv = g_k0 * o.c - g_k1 * o.b + g_k2 * o.a;
  float g_ds = -g_inv * o.inv_det * o.inv_det;
  // compensation = sqrt(ratio) where ratio > 1e-12, else 0.
  const float g_ratio =
      o.ratio_pos ? cot(g, 5, i, 0) / (2.0f * o.comp) : 0.0f;
  const float g_det_raw = g_ratio / o.det_safe;
  g_ds = g_ds - g_ratio * o.ratio / o.det_safe;
  const float g_det = o.ok_det ? g_ds : 0.0f;
  // det = a c - b^2 and det_raw = a_raw c_raw - b_raw^2 (a = a_raw + eps).
  const float g_a_raw = g_a + g_det * o.c + g_det_raw * o.c_raw;
  const float g_c_raw = g_c + g_det * o.a + g_det_raw * o.a_raw;
  const float g_b_raw = g_b - 2.0f * o.b * g_det - 2.0f * o.b_raw * g_det_raw;
  // Sigma2D = J Sigma_c J^T, the plane's J Sigma_c e_z folded in.
  const float c00 = o.cc[0], c01 = o.cc[1], c02 = o.cc[2], c11 = o.cc[3],
              c12 = o.cc[4], c22 = o.cc[5];
  const float g_ju0 = g_a_raw * o.j00;
  const float g_ju2 = g_a_raw * o.j02 + g_sut;
  const float g_jv0 = g_b_raw * o.j00;
  const float g_jv1 = g_c_raw * o.j11;
  const float g_jv2 = g_b_raw * o.j02 + g_c_raw * o.j12 + g_svt;
  const float g_j00 =
      g_a_raw * o.ju0 + g_b_raw * o.jv0 + g_ju0 * c00 + g_ju2 * c02;
  const float g_j02 =
      g_a_raw * o.ju2 + g_b_raw * o.jv2 + g_ju0 * c02 + g_ju2 * c22;
  const float g_j11 =
      g_c_raw * o.jv1 + g_jv0 * c01 + g_jv1 * c11 + g_jv2 * c12;
  const float g_j12 =
      g_c_raw * o.jv2 + g_jv0 * c02 + g_jv1 * c12 + g_jv2 * c22;
  const float g_c00 = g_ju0 * o.j00;
  const float g_c01 = g_jv0 * o.j11;
  const float g_c02 = g_ju0 * o.j02 + g_ju2 * o.j00 + g_jv0 * o.j12;
  const float g_c11 = g_jv1 * o.j11;
  const float g_c12 = g_jv1 * o.j12 + g_jv2 * o.j11;
  const float g_c22 = g_ju2 * o.j02 + g_jv2 * o.j12;
  // J = [[fx rz, 0, -fx x rz^2], [0, fy rz, -fy y rz^2]] and mean2d.
  const float rz = o.rz, rz2 = rz * rz;
  const float g_x = -fx * rz2 * g_j02 + fx * rz * g_u;
  const float g_y = -fy * rz2 * g_j12 + fy * rz * g_v;
  const float g_rz2 = -fx * o.x * g_j02 - fy * o.y * g_j12;
  const float g_rz = fx * g_j00 + fy * g_j11 + fx * o.x * g_u +
                     fy * o.y * g_v + 2.0f * rz * g_rz2;
  g_zs = g_zs - g_rz * rz * rz;
  const float g_z = cot(g, 1, i, 0) + (o.in_depth ? g_zs : 0.0f);
  const float* w = cam.w;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v_means[3 * i + k] = g_x * w[k] + g_y * w[3 + k] + g_z * w[6 + k];
  }

  // Sigma_c = W Sigma_w W^T reads its upper triangle: with Gs = G_c +
  // G_c^T, Sigma_w = M M^T and M = R diag(s), G_M = W^T Gs W M.
  const float gs[9] = {2.0f * g_c00, g_c01, g_c02,
                       g_c01, 2.0f * g_c11, g_c12,
                       g_c02, g_c12, 2.0f * g_c22};
  float gw[9], sw[9], gm[9];
#pragma unroll
  for (int a = 0; a < 3; ++a) {  // Gs W
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      gw[3 * a + b] = gs[3 * a] * w[b] + gs[3 * a + 1] * w[3 + b] +
                      gs[3 * a + 2] * w[6 + b];
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {  // W^T (Gs W)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      sw[3 * a + b] = w[a] * gw[b] + w[3 + a] * gw[3 + b] +
                      w[6 + a] * gw[6 + b];
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {  // (W^T Gs W) M
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      gm[3 * a + b] = (sw[3 * a] * o.r[b] + sw[3 * a + 1] * o.r[3 + b] +
                       sw[3 * a + 2] * o.r[6 + b]) * o.s[b];
    }
  }
  float G[9];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    v_scales[3 * i + b] =
        gm[b] * o.r[b] + gm[3 + b] * o.r[3 + b] + gm[6 + b] * o.r[6 + b];
#pragma unroll
    for (int a = 0; a < 3; ++a) G[3 * a + b] = gm[3 * a + b] * o.s[b];
  }
  // R of the unit quaternion (w, x, y, z), then qn = q / q_len.
  const float iq = 1.0f / o.q_len;
  const float qw = o.q[0] * iq, qx = o.q[1] * iq, qy = o.q[2] * iq,
              qz = o.q[3] * iq;
  float gq[4];
  gq[0] = 2.0f * (-qz * G[1] + qy * G[2] + qz * G[3] - qx * G[5] -
                  qy * G[6] + qx * G[7]);
  gq[1] = 2.0f * (qy * G[1] + qz * G[2] + qy * G[3] - 2.0f * qx * G[4] -
                  qw * G[5] + qz * G[6] + qw * G[7] - 2.0f * qx * G[8]);
  gq[2] = 2.0f * (-2.0f * qy * G[0] + qx * G[1] + qw * G[2] + qx * G[3] +
                  qz * G[5] - qw * G[6] + qz * G[7] - 2.0f * qy * G[8]);
  gq[3] = 2.0f * (-2.0f * qz * G[0] - qw * G[1] + qx * G[2] + qw * G[3] -
                  2.0f * qz * G[4] + qy * G[5] + qx * G[6] + qy * G[7]);
  const float qdot = o.q[0] * gq[0] + o.q[1] * gq[1] + o.q[2] * gq[2] +
                     o.q[3] * gq[3];
  const float qd3 = qdot * iq * iq * iq;
#pragma unroll
  for (int k = 0; k < 4; ++k) v_quats[4 * i + k] = gq[k] * iq - o.q[k] * qd3;
  if (gcam == nullptr) return;

  // The camera: p_cam = W m + t gives g_p m^T and g_p; Sigma_c = W Sigma_w
  // W^T gives Gs W Sigma_w; J, mean2d and n_raw give the intrinsics' (cx
  // reaches the normal's u - cx twice, which cancel).
  const float gp[3] = {g_x, g_y, g_z};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      gcam[3 * a + b] = gp[a] * o.m[b] + gw[3 * a] * o.cw[b] +
                        gw[3 * a + 1] * o.cw[3 + b] +
                        gw[3 * a + 2] * o.cw[6 + b];
    }
    gcam[9 + a] = gp[a];
  }
  gcam[12] = g_j00 * rz - o.x * rz2 * g_j02 + o.x * rz * g_u - o.pu * g_nr0;
  gcam[13] = g_j11 * rz - o.y * rz2 * g_j12 + o.y * rz * g_v - o.pv * g_nr1;
  gcam[14] = cot(g, 0, i, 0);
  gcam[15] = cot(g, 0, i, 1);
}

// kCamera: each block also writes the sum of its rows' camera gradients
// to cam_partials[blockIdx.x], which project_camera_reduce_kernel sums.
template <bool kCamera>
__global__ void __launch_bounds__(kThreads) project_bwd_kernel(
    const float* __restrict__ means, const float* __restrict__ quats,
    const float* __restrict__ scales, const float* __restrict__ viewmat,
    const float* __restrict__ K, int n, float eps2d, float near_plane,
    float far_plane, Cotangents g, float* __restrict__ v_means,
    float* __restrict__ v_quats, float* __restrict__ v_scales,
    float* __restrict__ cam_partials) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float gcam[kCamGrads];
#pragma unroll
  for (int k = 0; k < kCamGrads; ++k) gcam[k] = 0.0f;
  if (i < n) {
    const Camera cam = load_camera(viewmat, K);
    row_backward(means, quats, scales, i, cam, eps2d, near_plane, far_plane,
                 g, v_means, v_quats, v_scales, kCamera ? gcam : nullptr);
  }
  if (kCamera) block_sum(gcam, cam_partials + kCamGrads * blockIdx.x);
}

// The camera's gradient: the blocks' partial sums summed in a fixed order
// (so a step repeats bit for bit), written as v_viewmat [4, 4] and v_K
// [3, 3] with zeros where the projection reads nothing.
__global__ void __launch_bounds__(kThreads) project_camera_reduce_kernel(
    const float* __restrict__ partials, int n_blocks,
    float* __restrict__ v_viewmat, float* __restrict__ v_K) {
  __shared__ float tot[kCamGrads];
  float v[kCamGrads];
#pragma unroll
  for (int k = 0; k < kCamGrads; ++k) v[k] = 0.0f;
  for (int b = threadIdx.x; b < n_blocks; b += kThreads) {
#pragma unroll
    for (int k = 0; k < kCamGrads; ++k) v[k] += partials[kCamGrads * b + k];
  }
  block_sum(v, tot);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < 16) {
    const int r = t / 4, c = t % 4;
    v_viewmat[t] = r == 3 ? 0.0f : (c == 3 ? tot[9 + r] : tot[3 * r + c]);
  }
  if (t < 9) {
    // K's entries fx (0), cx (2), fy (4), cy (5).
    const int from[9] = {12, -1, 14, -1, 13, 15, -1, -1, -1};
    v_K[t] = from[t] < 0 ? 0.0f : tot[from[t]];
  }
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int project_fwd(const void* means, const void* quats,
                           const void* scales, const void* opacities,
                           const void* viewmat, const void* K, int n,
                           int width, int height, float eps2d,
                           float near_plane, float far_plane,
                           float radius_clip, void* mean2d, void* depth,
                           void* conic, void* radius, void* comp, void* plane,
                           void* normal, void* valid, void* radius_xy,
                           void* stream) {
  project_fwd_kernel<<<blocks(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(means), static_cast<const float*>(quats),
      static_cast<const float*>(scales),
      static_cast<const float*>(opacities),
      static_cast<const float*>(viewmat), static_cast<const float*>(K), n,
      static_cast<float>(width), static_cast<float>(height), eps2d,
      near_plane, far_plane, radius_clip, static_cast<float*>(mean2d),
      static_cast<float*>(depth), static_cast<float*>(conic),
      static_cast<float*>(radius), static_cast<float*>(comp),
      static_cast<float*>(plane), static_cast<float*>(normal),
      static_cast<bool*>(valid), static_cast<float*>(radius_xy));
  return static_cast<int>(cudaGetLastError());
}

// cot: the six cotangents' base pointers (each may be null) and strides: in
// the order mean2d, depth, conic, plane, normal, compensation.
// cam_partials: null, or room for 16 floats a block of 256 rows, and then
// the camera's gradient goes to v_viewmat [4, 4] and v_K [3, 3] too.
extern "C" int project_bwd(const void* means, const void* quats,
                           const void* scales, const void* viewmat,
                           const void* K, int n, float eps2d,
                           float near_plane, float far_plane,
                           const void* const* cot,
                           const long long* strides, void* v_means,
                           void* v_quats, void* v_scales, void* cam_partials,
                           void* v_viewmat, void* v_K, void* stream) {
  Cotangents g;
  for (int k = 0; k < 6; ++k) {
    g.p[k] = static_cast<const float*>(cot[k]);
    g.stride[k] = strides[k];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool camera = cam_partials != nullptr;
  (camera ? project_bwd_kernel<true> : project_bwd_kernel<false>)
      <<<blocks(n), kThreads, 0, st>>>(
          static_cast<const float*>(means), static_cast<const float*>(quats),
          static_cast<const float*>(scales),
          static_cast<const float*>(viewmat), static_cast<const float*>(K),
          n, eps2d, near_plane, far_plane, g, static_cast<float*>(v_means),
          static_cast<float*>(v_quats), static_cast<float*>(v_scales),
          static_cast<float*>(cam_partials));
  if (!camera) return static_cast<int>(cudaGetLastError());
  project_camera_reduce_kernel<<<1, kThreads, 0, st>>>(
      static_cast<const float*>(cam_partials), blocks(n),
      static_cast<float*>(v_viewmat), static_cast<float*>(v_K));
  return static_cast<int>(cudaGetLastError());
}
