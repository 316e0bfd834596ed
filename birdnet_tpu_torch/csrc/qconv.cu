// Int8 1x1 convolution with the requantize epilogue fused (B3), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel birdnet_tpu/ops/pallas/qconv.py
// (qconv1x1_requant, kernel _qconv_kernel). Per image b:
//   acc[m, n] = sum_k w[m, k] * x[b, k, n]            (int8 x int8 -> int32)
//   v = f32(acc + bias[m]) * scale[m]                 (scale = x_s * w_s[m])
//   out[b, m, n] = saturate_s8(rint(act(v) / y_scale))
// bit for bit as the unfused lowering (birdnet_tpu/compiler/ops.py
// _requantize): every rounding step is an explicit _rn intrinsic, so nvcc
// cannot contract anything into an FMA, and the output scale DIVIDES (a
// multiply by its f32 reciprocal flips round-half-even ties). The sigmoid is
// torch's own formula, 1 / (1 + exp(-v)), so the card's check can demand the
// plain version's codes.
//
// What bounds it on this card. The 1x1 convs of BirdNET v2.4 move one byte in
// and one byte out per element and do 2 * C_in operations per output; at the
// widest spatial size (C_in 24 -> C_out 96 over 48 x 256) that is ~48 ops per
// byte, far below the card's int8 ridge: they are bound by device memory.
// The SE convs (N = 1) are tiny and bound by launch latency. This first
// version keeps the int32 accumulator and the whole epilogue in registers
// (the TPU kernel's point: nothing but int8 touches device memory) and runs
// the products on __dp4a: one block per (image, 64 output channels,
// 64 positions) stages a 64 x 32 tile of w and a 32 x 64 tile of x in shared
// memory, transposed so that four consecutive input channels form one 32-bit
// word, zero-padded past C_in (C_in = 6 occurs) and past the tile's edges;
// each of 256 threads keeps a 4 x 4 register block. Rows are padded to an odd
// number of words, so the tile reads are free of bank conflicts. Tensor cores
// (mma.sync s8 or wgmma fed by TMA) are later work.
//
// Plain C entry point, loaded with ctypes: it launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTileM = 64;                 // output channels per block
constexpr int kTileN = 64;                 // positions per block
constexpr int kTileK = 32;                 // input channels per stage
constexpr int kRowWords = kTileK / 4 + 1;  // one staged row, in 32-bit words
constexpr int kThreads = 256;              // 16 x 16, each 4 x 4 outputs

// Activation codes, as ops/cuda/qconv.py passes them.
enum Act : int { kNone = 0, kRelu = 1, kSigmoid = 2, kSilu = 3, kTanh = 4 };

__device__ __forceinline__ float sigmoid_rn(float v) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu:
      return v < 0.0f ? 0.0f : v;
    case kSigmoid:
      return sigmoid_rn(v);
    case kSilu:
      return __fmul_rn(v, sigmoid_rn(v));
    case kTanh:
      return tanhf(v);
    default:
      return v;
  }
}

__global__ void __launch_bounds__(kThreads)
qconv1x1_requant_kernel(const int8_t* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const int32_t* __restrict__ bias,
                        const float* __restrict__ scale,
                        int8_t* __restrict__ out, int C_in, int C_out, int N,
                        float y_scale, int act) {
  __shared__ int32_t s_w[kTileM][kRowWords];  // [m][k / 4]
  __shared__ int32_t s_x[kTileN][kRowWords];  // [n][k / 4]
  int8_t* s_w8 = reinterpret_cast<int8_t*>(&s_w[0][0]);
  int8_t* s_x8 = reinterpret_cast<int8_t*>(&s_x[0][0]);
  constexpr int kRowBytes = kRowWords * 4;

  const int b = blockIdx.z;
  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int8_t* xb = x + static_cast<size_t>(b) * C_in * N;

  int acc[4][4] = {};
  for (int k0 = 0; k0 < C_in; k0 += kTileK) {
    for (int i = threadIdx.x; i < kTileM * kTileK; i += kThreads) {
      const int m = i / kTileK, k = i % kTileK;
      const int gm = m0 + m, gk = k0 + k;
      s_w8[m * kRowBytes + k] =
          (gm < C_out && gk < C_in) ? w[static_cast<size_t>(gm) * C_in + gk] : 0;
    }
    // Neighbouring threads read neighbouring positions of one channel row.
    for (int i = threadIdx.x; i < kTileK * kTileN; i += kThreads) {
      const int k = i / kTileN, n = i % kTileN;
      const int gk = k0 + k, gn = n0 + n;
      s_x8[n * kRowBytes + k] =
          (gk < C_in && gn < N) ? xb[static_cast<size_t>(gk) * N + gn] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kTileK / 4; ++kw) {
      int a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_w[ty + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = s_x[tx + 16 * j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], c[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= C_out) continue;
    const uint32_t bm = bias != nullptr ? static_cast<uint32_t>(bias[m]) : 0u;
    const float sm = scale[m];
    int8_t* row = out + (static_cast<size_t>(b) * C_out + m) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      // int32 add wrapping as the reference's, then the f32 epilogue.
      const int32_t s = static_cast<int32_t>(static_cast<uint32_t>(acc[i][j]) + bm);
      const float v = activate(__fmul_rn(__int2float_rn(s), sm), act);
      const float q = fminf(fmaxf(rintf(__fdiv_rn(v, y_scale)), -128.0f), 127.0f);
      row[n] = static_cast<int8_t>(__float2int_rn(q));
    }
  }
}

}  // namespace

// x [B, C_in, N] int8, w [C_out, C_in] int8, bias [C_out] int32 (or null),
// scale [C_out] float32, out [B, C_out, N] int8; all contiguous on one card.
extern "C" int bn_qconv1x1_requant(const void* x, const void* w,
                                   const void* bias, const void* scale,
                                   void* out, int B, int C_in, int C_out,
                                   int N, float y_scale, int act,
                                   void* stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, (C_out + kTileM - 1) / kTileM, B);
  qconv1x1_requant_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), static_cast<const float*>(scale),
      static_cast<int8_t*>(out), C_in, C_out, N, y_scale, act);
  return static_cast<int>(cudaGetLastError());
}
