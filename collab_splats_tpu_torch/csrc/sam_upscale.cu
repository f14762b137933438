// SAM's mask upscaling and mask product, fused: from the mask decoder's
// image features to its low-resolution mask logits.
//
// Replaces no Pallas kernel: the JAX package leaves features/sam.py::
// mask_decoder_forward's two jax.lax.conv_transpose calls, the channel
// LayerNorm, both GELUs and the hypernetwork product to XLA.  The port ran
// them as F.conv_transpose2d (cuDNN's data-gradient kernels, in float32),
// layer_norm on a permuted view, two F.gelu and hyper @ x, writing a
// [B, 64, 128, 128] and a [B, 32, 256, 256] intermediate to device memory
// (features/sam.py::upscale_masks_plain).  This kernel computes the same
// function for a batch of prompts in one launch, nothing but the masks
// reaching device memory:
//
//   y1  = x . W1' + b1            x [64 pixels, 256], W1' [256, (dy, dx, 64)]
//   y1  = GELU(LN64(y1))          per (pixel, dy, dx), eps 1e-6
//   y2  = GELU(y1 . W2' + b2)     W2' [64, (dy2, dx2, 32)], each (dy, dx)
//   out = y2 . hyper[b]^T         [M <= 4] per output pixel
//
// A 2x2 transposed convolution at stride 2 reads one input pixel for each
// output pixel, so each layer is one product followed by a pixel shuffle:
// output row 4y + 2dy + dy2 and column 4x + 2dx + dx2 come from input
// pixel (y, x).
//
// Bound on the H100: operations.  A pixel costs 2 * (256 * 256 + 4 * 64 *
// 128 + 16 * 32 * 4) = 200,704 float32 operations; a batch of 64 prompts
// (262,144 pixels) 52.6 GFLOP, 0.79 ms at 67 TFLOP/s.  Its bytes (x read
// once, 268 MB, the masks written once, 67 MB) take 0.10 ms at 3.35 TB/s.
//
// Design.  A block takes one prompt's image row (64 pixels): a [64, 256] x
// [256, 256] product, register-tiled in float32 FFMA (8 pixels x 8 columns a
// thread; a warp covers 16 pixels x 128 columns, its two halves of 16 lanes
// taking alternate pixels so that their reads of x fall in other banks), x
// and W1' streamed through shared memory in K-chunks of 16 by cp.async in a
// three-stage ring.  The bias, LayerNorm and GELU run on the accumulators
// (a thread holds 4 channels of two sub-pixels; the 16 lanes of a half-warp
// hold all 64 of one, so the LayerNorm's sums are four shuffles); the result
// goes to shared memory ([64, 256]), over the ring.  W2' (32 KB) is resident.
// The second product runs one output row pair (dy) at a time, again 8 x 8 a
// thread, then the bias, GELU and the product with hyper[b] on the
// accumulators (three shuffles over the 8 lanes that hold one sub-pixel's 32
// channels); the masks' 4 x 256 strip goes through shared memory so that its
// stores are whole rows.  No TF32, no fast math, no atomics: every output
// is written by one thread, its sums in a fixed order.

#include <cuda_runtime.h>

namespace {

constexpr int kPix = 64;     // pixels of an image row: a block's rows
constexpr int kC0 = 256;     // the decoder's width
constexpr int kC1 = 64;      // the first upscaling's channels
constexpr int kC2 = 32;      // the second's
constexpr int kSlots = 4;    // mask slots at most
constexpr int kN1 = 4 * kC1; // W1' columns: (dy, dx, c1)
constexpr int kN2 = 4 * kC2; // W2' columns: (dy2, dx2, c2)
constexpr int kOut = 256;    // the masks' side
constexpr int kKC = 16;      // the first product's K-chunk
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr float kEps = 1e-6f;  // the upscaling's channel LayerNorm
constexpr int kYS = kN1 + 4; // the first product's result: row stride
// Shared memory, in floats: the ring (or the first product's result), W2',
// the masks' strip for one dy, hyper[b], b1, the LayerNorm's scale and
// bias, b2.
constexpr int kRing = kStages * (kPix * kKC + kKC * kN1);
constexpr int kRegion = kRing > kPix * kYS ? kRing : kPix * kYS;
constexpr int kSmemFloats = kRegion + kC1 * kN2 + kSlots * 2 * kOut +
                            kSlots * kC2 + 3 * kC1 + kC2;
constexpr int kSmemBytes = kSmemFloats * 4;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
// F.gelu's exact form, as PyTorch's CUDA kernel computes it.
__device__ __forceinline__ float gelu(float x) {
  return x * 0.5f * (1.0f + erff(x * 0.70710678118654752440f));
}

// acc[i][0..3] += a_i * lo, acc[i][4..7] += a_i * hi, for 8 rows i.
__device__ __forceinline__ void fma_rows(float (&acc)[8][8],
                                         const float4 (&a)[8], int k,
                                         const float4& lo, const float4& hi) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float ai = lane_of(a[i], k);
    acc[i][0] = fmaf(ai, lo.x, acc[i][0]);
    acc[i][1] = fmaf(ai, lo.y, acc[i][1]);
    acc[i][2] = fmaf(ai, lo.z, acc[i][2]);
    acc[i][3] = fmaf(ai, lo.w, acc[i][3]);
    acc[i][4] = fmaf(ai, hi.x, acc[i][4]);
    acc[i][5] = fmaf(ai, hi.y, acc[i][5]);
    acc[i][6] = fmaf(ai, hi.z, acc[i][6]);
    acc[i][7] = fmaf(ai, hi.w, acc[i][7]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    sam_upscale_kernel(const float* __restrict__ im,
                       const float* __restrict__ w1,
                       const float* __restrict__ b1,
                       const float* __restrict__ ln_w,
                       const float* __restrict__ ln_b,
                       const float* __restrict__ w2,
                       const float* __restrict__ b2,
                       const float* __restrict__ hyper, int slots,
                       float* __restrict__ masks) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const ring_a = smem;                          // [stage][64][kKC]
  float* const ring_b = smem + kStages * kPix * kKC;   // [stage][kKC][kN1]
  float* const ys = smem;                              // [64][kYS]
  float* const w2s = smem + kRegion;                   // [64][128]
  float* const outs = w2s + kC1 * kN2;                 // [M][2][256]
  float* const hs = outs + kSlots * 2 * kOut;          // [4][32]
  float* const b1s = hs + kSlots * kC2;
  float* const lnws = b1s + kC1;
  float* const lnbs = lnws + kC1;
  float* const b2s = lnbs + kC1;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = lane & 15;
  // This thread's pixels p0 + 2i, and its columns col0 + [0, 4) and
  // col0 + 64 + [0, 4) of W1'.
  const int p0 = (warp & 3) * 16 + (lane >> 4);
  const int row = static_cast<int>(blockIdx.x);  // b * 64 + y
  const int b = row >> 6, y = row & 63;
  const float* const x = im + static_cast<size_t>(row) * kPix * kC0;

  for (int i = tid; i < kC1 * kN2 / 4; i += kThreads)
    cp_async16(w2s + 4 * i, w2 + 4 * i);
  for (int i = tid; i < kC1; i += kThreads) {
    b1s[i] = b1[i];
    lnws[i] = ln_w[i];
    lnbs[i] = ln_b[i];
  }
  for (int i = tid; i < kC2; i += kThreads) b2s[i] = b2[i];
  for (int i = tid; i < kSlots * kC2; i += kThreads) {
    const int m = i / kC2;
    hs[i] = m < slots
                ? hyper[(static_cast<size_t>(b) * slots + m) * kC2 + i % kC2]
                : 0.0f;
  }

  auto load_chunk = [&](int kc, int stage) {
    float* const a = ring_a + stage * kPix * kKC;
    for (int i = tid; i < kPix * kKC / 4; i += kThreads) {
      const int px = i / (kKC / 4), q = i % (kKC / 4);
      cp_async16(a + px * kKC + 4 * q,
                 x + static_cast<size_t>(px) * kC0 + kc * kKC + 4 * q);
    }
    float* const bs = ring_b + stage * kKC * kN1;
    for (int i = tid; i < kKC * kN1 / 4; i += kThreads) {
      const int k = i / (kN1 / 4), q = i % (kN1 / 4);
      cp_async16(bs + k * kN1 + 4 * q,
                 w1 + static_cast<size_t>(kc * kKC + k) * kN1 + 4 * q);
    }
  };

  // ---- First product: [64, 256] x [256, kN1].
  const int col0 = (warp >> 2) * 128 + 4 * c;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  constexpr int kChunks = kC0 / kKC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load_chunk(s, s);
    cp_async_commit();  // the first group holds W2' too
  }
#pragma unroll 1
  for (int kc = 0; kc < kChunks; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kc + kStages - 1 < kChunks)
      load_chunk(kc + kStages - 1, (kc + kStages - 1) % kStages);
    cp_async_commit();
    const float* const a = ring_a + (kc % kStages) * kPix * kKC;
    const float* const bs = ring_b + (kc % kStages) * kKC * kN1 + col0;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = ld4(a + (p0 + 2 * i) * kKC + kk);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        fma_rows(acc, av, k, ld4(bs + (kk + k) * kN1),
                 ld4(bs + (kk + k) * kN1 + 64));
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the result goes over it

  // ---- Bias, LayerNorm over each sub-pixel's 64 channels, GELU.  The
  // thread's columns are channels 4c + j of sub-pixels (dy, 0) and (dy, 1).
  {
    const int dy = warp >> 2;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[4];
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = acc[i][4 * h + j] + b1s[4 * c + j];
          s += v[j];
        }
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        const float mean = s * (1.0f / kC1);
        float q = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] -= mean;
          q = fmaf(v[j], v[j], q);
        }
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
          q += __shfl_xor_sync(0xffffffffu, q, off);
        const float rstd = rsqrtf(q * (1.0f / kC1) + kEps);
        float4 o;
        o.x = gelu(lnws[4 * c + 0] * v[0] * rstd + lnbs[4 * c + 0]);
        o.y = gelu(lnws[4 * c + 1] * v[1] * rstd + lnbs[4 * c + 1]);
        o.z = gelu(lnws[4 * c + 2] * v[2] * rstd + lnbs[4 * c + 2]);
        o.w = gelu(lnws[4 * c + 3] * v[3] * rstd + lnbs[4 * c + 3]);
        *reinterpret_cast<float4*>(ys + (p0 + 2 * i) * kYS + dy * 128 +
                                   h * 64 + 4 * c) = o;
      }
    }
  }
  __syncthreads();

  // ---- Second product, GELU and the mask product, one output row pair
  // (dy) at a time: the warp's 16 pixels of sub-pixel (dy, dx) x W2'.
  const int c2 = 4 * (c & 7), dx2 = c >> 3;
  auto flush = [&](int dy) {
    float* const dst = masks + static_cast<size_t>(b) * slots * kOut * kOut +
                       static_cast<size_t>(4 * y + 2 * dy) * kOut;
    for (int i = tid; i < slots * 2 * kOut / 4; i += kThreads) {
      const int m = i / (2 * kOut / 4), r = i % (2 * kOut / 4);
      reinterpret_cast<float4*>(dst + static_cast<size_t>(m) * kOut * kOut)[r] =
          reinterpret_cast<const float4*>(outs + m * 2 * kOut)[r];
    }
  };
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const int dy = pass, dx = warp >> 2;
    const float* const a = ys + dy * 128 + dx * 64;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
    for (int k0 = 0; k0 < kC1; k0 += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = ld4(a + (p0 + 2 * i) * kYS + k0);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        fma_rows(acc, av, k, ld4(w2s + (k0 + k) * kN2 + 4 * c),
                 ld4(w2s + (k0 + k) * kN2 + 64 + 4 * c));
    }
    // Columns 4c + j are (dy2 0, dx2, c2 + j), 64 + 4c + j are (dy2 1, ...):
    // 8 lanes hold one sub-pixel's 32 channels.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float part[2][kSlots];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int m = 0; m < kSlots; ++m) part[h][m] = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float g = gelu(acc[i][4 * h + j] + b2s[c2 + j]);
#pragma unroll
          for (int m = 0; m < kSlots; ++m)
            part[h][m] = fmaf(hs[m * kC2 + c2 + j], g, part[h][m]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int m = 0; m < kSlots; ++m)
#pragma unroll
          for (int off = 1; off < 8; off <<= 1)
            part[h][m] += __shfl_xor_sync(0xffffffffu, part[h][m], off);
      if ((c & 7) == i) {
        const int col = 4 * (p0 + 2 * i) + 2 * dx + dx2;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int m = 0; m < kSlots; ++m)
            outs[(m * 2 + h) * kOut + col] = part[h][m];
      }
    }
    __syncthreads();
    flush(dy);
    __syncthreads();
  }
}

}  // namespace

// im [batch, 4096, 256]; w1 [256, 256] = up1.w as [c0, (dy, dx, c1)];
// b1, ln_w, ln_b [64]; w2 [64, 128] = up2.w as [c1, (dy2, dx2, c2)]; b2
// [32]; hyper [batch, slots, 32] with 1 <= slots <= 4; masks [batch, slots,
// 256, 256].  All contiguous float32 on the current device.
extern "C" int sam_upscale(const void* im, const void* w1, const void* b1,
                           const void* ln_w, const void* ln_b, const void* w2,
                           const void* b2, const void* hyper, int batch,
                           int slots, void* masks, void* stream) {
  // The shared-memory limit is set once for each device (bit d of `ready`).
  static unsigned long long ready = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !(ready >> dev & 1ull)) {
    const cudaError_t rc = cudaFuncSetAttribute(
        sam_upscale_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (dev < 64) ready |= 1ull << dev;
  }
  sam_upscale_kernel<<<batch * kPix, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(im), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(hyper), slots,
      static_cast<float*>(masks));
  return static_cast<int>(cudaGetLastError());
}
