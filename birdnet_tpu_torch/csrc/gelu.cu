// The exact-erf GELU with the prologue that feeds it, in one pass over device
// memory, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves these chains to XLA's
// fusion. The port lowers them node by node, and under the bfloat16 policies
// a float32 bias or LayerNorm scale lifts the bf16 activation to float32
// (jax.numpy's promotion), so the chain below is five to nine float32 passes
// through device memory. compiler/fuse_gelu.py bundles each chain into one
// _FusedGelu node; its lowering (compiler/ops.py) launches one of these:
//
//   bias_gelu_kernel         v = float(x) + bias[col]  (bias form), or float(x)
//   channel_ln_gelu_kernel   x [N, C, T]; per (n, t) over the C channels:
//                            m = r(mean), s2 = r(var), both summed in f32;
//                            inv = r(rsqrt(r(s2 + eps)));
//                            y = r(r(x - m) * inv);
//                            v = y * scale[c] + shift[c]                (f32)
//                            with r() the rounding to x's type (bf16, f16,
//                            or none for f32), where the lowering keeps it
//   then, for both           g = (v * (erf(v / c) + 1)) * 0.5   or
//                            g = (v * 0.5) * (erf(v / c) + 1)   (Mul order),
//                            with v * c for an exporter's Mul by 1/sqrt 2,
//   stored as bf16 where every reader of the node rounds to bf16 anyway (a
//   product's operand), else as float32.
//
// The same arithmetic as the unfused lowering, in the same order and
// precision: every float32 step is an explicit _rn intrinsic, so nvcc
// contracts nothing into an FMA; the division is a true division (ATen's,
// by a 0-d tensor on the card); erff and rsqrtf are the functions ATen's
// erf and rsqrt call. The bias and bare forms are therefore bit for bit the
// unfused chain. The LayerNorm statistics sum in another order than ATen's
// reductions, which can move one rounding of a statistic.
//
// What bounds it on this card: device memory by count, 2 bytes read and 2
// (or 4) written an element, where the unfused chain moves ~64-100. An
// element costs ~40-75 instructions (the division, erff, the LayerNorm
// steps), so the instruction rate follows close behind: on an H100 at 700 W
// the bias form runs at ~63 % of the byte bound, the LayerNorm form at
// ~33-43 %.
//
// The design.
//   - bias_gelu_kernel: a thread owns 8 consecutive columns (16-byte loads
//     and stores where the rows allow it, else one element), holds their
//     bias in registers for the whole block, and walks rows with a stride of
//     the grid's rows of blocks. Rows may have a stride of their own (a
//     sliced view, the positional conv's GELU), so no copy precedes it.
//   - channel_ln_gelu_kernel: a block of 16 warps owns all channels (at most
//     512) of 32 frames of one segment; lane = frame, so each warp load reads
//     32 consecutive frames of one channel (T, the contiguous axis, is odd in
//     the encoder, so loads are one element). Warp w holds channels w,
//     w + 16, ... as raw bits, two to a register for bf16 or f16 (64
//     registers a thread keep two blocks on an SM), one for f32 (one
//     block): the strip is read from device memory once. The per-frame
//     sums reduce across the 16 warps through shared memory.
//
// Plain C entry points, loaded with ctypes: they launch on the caller's
// stream, allocate nothing, and return cudaGetLastError() after the launch.
// x is bf16, f16 or f32 (`in_type` 0, 1, 2): the activation types the
// bfloat16 policies produce; the kernels are instantiated for each.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                       // columns a thread owns, 16 bytes of bf16
constexpr int kLnThreads = 512;               // channel_ln: one frame a lane, 16 warps
constexpr int kLnWarps = kLnThreads / 32;     // channel groups of a block
constexpr int kLnPerThread = 32;              // channels a thread holds
constexpr int kLnMaxChannels = kLnWarps * kLnPerThread;  // 512

// An activation type: its loads as float32, its raw bits (16 bits of a
// 2-byte type in the low half of a word), and the rounding of a float32
// value to it.
template <typename T>
struct Io;

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ uint32_t raw(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ float unpack(uint32_t r) { return __uint_as_float(r << 16); }
  static __device__ __forceinline__ float rounded(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <>
struct Io<__half> {
  static constexpr int kPerWord = 2;
  static __device__ __forceinline__ float load(const __half* p) { return __half2float(p[0]); }
  static __device__ __forceinline__ uint32_t raw(const __half* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ float unpack(uint32_t r) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(r)));
  }
  static __device__ __forceinline__ float rounded(float v) {
    return __half2float(__float2half_rn(v));
  }
};

template <>
struct Io<float> {
  static constexpr int kPerWord = 1;
  static __device__ __forceinline__ float load(const float* p) { return p[0]; }
  static __device__ __forceinline__ uint32_t raw(const float* p) {
    return __float_as_uint(__ldg(p));
  }
  static __device__ __forceinline__ float unpack(uint32_t r) { return __uint_as_float(r); }
  static __device__ __forceinline__ float rounded(float v) { return v; }
};

// Eight consecutive values of x from a 16-byte aligned address, as float32.
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* v) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(src));
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t word = words[i / 2];
    v[i] = __uint_as_float(i % 2 ? word & 0xFFFF0000u : word << 16);
  }
}

__device__ __forceinline__ void load8(const __half* src, float* v) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(src));
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 two = __half22float2(*reinterpret_cast<const __half2*>(&words[i]));
    v[2 * i] = two.x;
    v[2 * i + 1] = two.y;
  }
}

__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(src));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(src + 4));
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// Channel j of a thread's strip (raw bits, Io<T>::kPerWord to a register),
// as float32.
template <typename T>
__device__ __forceinline__ float channel(const uint32_t* bits, int j) {
  if constexpr (Io<T>::kPerWord == 1) {
    return Io<T>::unpack(bits[j]);
  } else {
    const uint32_t word = bits[j / 2];
    return Io<T>::unpack(j % 2 ? word >> 16 : word & 0xFFFFu);
  }
}

// The GELU of the float32 value v: v / c (or v * c), erf, + 1, and the two
// Muls in the exported order.
__device__ __forceinline__ float gelu(float v, float c, bool divide, bool half_first) {
  const float u = divide ? __fdiv_rn(v, c) : __fmul_rn(v, c);
  const float e1 = __fadd_rn(erff(u), 1.0f);
  return half_first ? __fmul_rn(__fmul_rn(v, 0.5f), e1) : __fmul_rn(__fmul_rn(v, e1), 0.5f);
}

template <bool OUT_BF16>
__device__ __forceinline__ void store1(void* out, size_t at, float g) {
  if (OUT_BF16) {
    static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(g);
  } else {
    static_cast<float*>(out)[at] = g;
  }
}

template <typename T, int VEC, bool OUT_BF16>
__global__ void __launch_bounds__(kThreads) bias_gelu_kernel(
    const T* __restrict__ x, const float* __restrict__ bias, void* __restrict__ out,
    long long rows, int cols, long long ld, float c, int divide, int half_first) {
  const int col = (blockIdx.x * kThreads + threadIdx.x) * VEC;
  if (col >= cols) return;
  const bool div = divide != 0, half = half_first != 0;
  float b[VEC];
  if (VEC == kVec && bias != nullptr) {
    const float4 lo = *reinterpret_cast<const float4*>(bias + col);
    const float4 hi = *reinterpret_cast<const float4*>(bias + col + 4);
    b[0] = lo.x; b[1] = lo.y; b[2] = lo.z; b[3] = lo.w;
    b[4] = hi.x; b[5] = hi.y; b[6] = hi.z; b[7] = hi.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) b[i] = bias != nullptr && col + i < cols ? bias[col + i] : 0.0f;
  }
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const T* src = x + r * ld + col;
    const size_t at = static_cast<size_t>(r) * cols + col;
    if (VEC == kVec) {
      float g[kVec];
      load8(src, g);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float v = bias != nullptr ? __fadd_rn(g[i], b[i]) : g[i];
        g[i] = gelu(v, c, div, half);
      }
      if (OUT_BF16) {
        uint32_t packed[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 two = __floats2bfloat162_rn(g[2 * i], g[2 * i + 1]);
          packed[i] = *reinterpret_cast<const uint32_t*>(&two);
        }
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + at) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      } else {
        float* dst = static_cast<float*>(out) + at;
        *reinterpret_cast<float4*>(dst) = make_float4(g[0], g[1], g[2], g[3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(g[4], g[5], g[6], g[7]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (col + i >= cols) break;
        float v = Io<T>::load(src + i);
        if (bias != nullptr) v = __fadd_rn(v, b[i]);
        store1<OUT_BF16>(out, at + i, gelu(v, c, div, half));
      }
    }
  }
}

// A 2-byte activation keeps two blocks on an SM (64 registers a thread); a
// float32 one holds twice the words, so one.
template <typename T, bool OUT_BF16>
__global__ void __launch_bounds__(kLnThreads, Io<T>::kPerWord) channel_ln_gelu_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ shift,
    void* __restrict__ out, int C, int frames, int strips, float eps, float c, int divide,
    int half_first) {
  constexpr int kPerWord = Io<T>::kPerWord;
  __shared__ float sums[kLnWarps][32];
  __shared__ float squares[kLnWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x / strips;
  const int t = (blockIdx.x - n * strips) * 32 + lane;
  const bool live = t < frames;
  const size_t base = static_cast<size_t>(n) * C * frames + t;
  const T* src = x + base;
  const bool div = divide != 0, half = half_first != 0;

  // The thread's channels warp + j * kLnWarps, as raw bits kPerWord to a
  // register.
  uint32_t bits[kLnPerThread / kPerWord];
#pragma unroll
  for (int j = 0; j < kLnPerThread; j += kPerWord) {
    uint32_t word = 0u;
#pragma unroll
    for (int k = 0; k < kPerWord; ++k) {
      const int ch = warp + (j + k) * kLnWarps;
      const uint32_t r = live && ch < C ? Io<T>::raw(src + static_cast<size_t>(ch) * frames) : 0u;
      word |= r << (16 * k);
    }
    bits[j / kPerWord] = word;
  }
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kLnPerThread; ++j) sum = __fadd_rn(sum, channel<T>(bits, j));
  sums[warp][lane] = sum;
  __syncthreads();
  sum = 0.0f;
#pragma unroll
  for (int w = 0; w < kLnWarps; ++w) sum = __fadd_rn(sum, sums[w][lane]);
  const float mean = __fmul_rn(sum, __frcp_rn(static_cast<float>(C)));

  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < kLnPerThread; ++j) {
    const float d = __fsub_rn(channel<T>(bits, j), mean);
    if (warp + j * kLnWarps < C) sq = __fadd_rn(sq, __fmul_rn(d, d));
  }
  squares[warp][lane] = sq;
  __syncthreads();
  sq = 0.0f;
#pragma unroll
  for (int w = 0; w < kLnWarps; ++w) sq = __fadd_rn(sq, squares[w][lane]);
  if (!live) return;

  // The lowering's statistics keep the activation's type: each rounds to it.
  const float m = Io<T>::rounded(mean);
  const float var = Io<T>::rounded(__fdiv_rn(sq, static_cast<float>(C)));
  const float inv = Io<T>::rounded(rsqrtf(Io<T>::rounded(__fadd_rn(var, eps))));
#pragma unroll
  for (int j = 0; j < kLnPerThread; ++j) {
    const int ch = warp + j * kLnWarps;
    if (ch >= C) break;
    const float y =
        Io<T>::rounded(__fmul_rn(Io<T>::rounded(__fsub_rn(channel<T>(bits, j), m)), inv));
    const float a = __fadd_rn(__fmul_rn(y, __ldg(scale + ch)), __ldg(shift + ch));
    store1<OUT_BF16>(out, base + static_cast<size_t>(ch) * frames, gelu(a, c, div, half));
  }
}

int grid_rows(long long rows, int col_blocks) {
  // Enough blocks to fill the card several times over; each walks rows.
  const long long want = (132LL * 16 + col_blocks - 1) / col_blocks;
  long long g = rows < want ? rows : want;
  return static_cast<int>(g < 65535 ? g : 65535);
}

template <typename T, int VEC>
int launch_bias(const void* x, const void* bias, void* out, long long rows, int cols, long long ld,
                float c, int divide, int half_first, int out_bf16, cudaStream_t s) {
  const int col_blocks = (cols + kThreads * VEC - 1) / (kThreads * VEC);
  const dim3 grid(col_blocks, grid_rows(rows, col_blocks));
  const auto* xt = static_cast<const T*>(x);
  const auto* bb = static_cast<const float*>(bias);
  if (out_bf16) {
    bias_gelu_kernel<T, VEC, true><<<grid, kThreads, 0, s>>>(xt, bb, out, rows, cols, ld, c,
                                                              divide, half_first);
  } else {
    bias_gelu_kernel<T, VEC, false><<<grid, kThreads, 0, s>>>(xt, bb, out, rows, cols, ld, c,
                                                               divide, half_first);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bias_of(const void* x, const void* bias, void* out, long long rows, int cols,
                   long long ld, float c, int divide, int half_first, int out_bf16,
                   cudaStream_t s) {
  const bool vec = cols % kVec == 0 && ld % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 32 == 0 &&
                   (bias == nullptr || reinterpret_cast<uintptr_t>(bias) % 16 == 0);
  return vec ? launch_bias<T, kVec>(x, bias, out, rows, cols, ld, c, divide, half_first,
                                    out_bf16, s)
             : launch_bias<T, 1>(x, bias, out, rows, cols, ld, c, divide, half_first, out_bf16,
                                 s);
}

template <typename T>
int launch_ln(const void* x, const void* scale, const void* shift, void* out, long long blocks,
              int channels, int frames, int strips, float eps, float c, int divide,
              int half_first, int out_bf16, cudaStream_t s) {
  const auto* xt = static_cast<const T*>(x);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  if (out_bf16) {
    channel_ln_gelu_kernel<T, true><<<static_cast<unsigned>(blocks), kLnThreads, 0, s>>>(
        xt, sc, sh, out, channels, frames, strips, eps, c, divide, half_first);
  } else {
    channel_ln_gelu_kernel<T, false><<<static_cast<unsigned>(blocks), kLnThreads, 0, s>>>(
        xt, sc, sh, out, channels, frames, strips, eps, c, divide, half_first);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: rows of `cols` elements of the type `in_type` names (0 bf16, 1 f16,
// 2 f32), row r at x + r * ld; bias: float32 [cols] or null; out:
// contiguous [rows, cols], bf16 when out_bf16 else float32.
extern "C" int bn_bias_gelu(const void* x, const void* bias, void* out, long long rows, int cols,
                            long long ld, int in_type, float c, int divide, int half_first,
                            int out_bf16, void* stream) {
  if (rows <= 0 || cols <= 0 || ld < cols) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_type) {
    case 0:
      return launch_bias_of<__nv_bfloat16>(x, bias, out, rows, cols, ld, c, divide, half_first,
                                           out_bf16, s);
    case 1:
      return launch_bias_of<__half>(x, bias, out, rows, cols, ld, c, divide, half_first,
                                    out_bf16, s);
    case 2:
      return launch_bias_of<float>(x, bias, out, rows, cols, ld, c, divide, half_first,
                                   out_bf16, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x: contiguous [n, channels, frames] of the type `in_type` names; scale,
// shift: float32 [channels]; out: contiguous [n, channels, frames], bf16
// when out_bf16 else float32.
extern "C" int bn_channel_ln_gelu(const void* x, const void* scale, const void* shift, void* out,
                                  int n, int channels, int frames, int in_type, float eps, float c,
                                  int divide, int half_first, int out_bf16, void* stream) {
  if (n <= 0 || frames <= 0 || channels <= 0 || channels > kLnMaxChannels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int strips = (frames + 31) / 32;
  const long long blocks = static_cast<long long>(n) * strips;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_type) {
    case 0:
      return launch_ln<__nv_bfloat16>(x, scale, shift, out, blocks, channels, frames, strips, eps,
                                       c, divide, half_first, out_bf16, s);
    case 1:
      return launch_ln<__half>(x, scale, shift, out, blocks, channels, frames, strips, eps, c,
                               divide, half_first, out_bf16, s);
    case 2:
      return launch_ln<float>(x, scale, shift, out, blocks, channels, frames, strips, eps, c,
                              divide, half_first, out_bf16, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
