// The backbone's stage prefix for Hopper (sm_90a): stem + k MBConv blocks
// (B4).
//
// Replaces the Pallas TPU megakernel
// birdnet_tpu/ops/pallas/stage123.py::stage_stack_forward (_build_kernel).
// It computes the same function with the same rounding points: the stem in
// f32, cast to the compute type T; per block the 1x1 expand with T operands
// and f32 sums, + bias, silu, kept in f32 through the depthwise 3x3 (+ bias,
// silu); the squeeze-excite gate in f32 with an exact sigmoid;
// h3 = h2 * gate rounded to T; the 1x1 project with f32 sums, + bias, + the
// residual, rounded to T. fast_act makes the stem/expand/depthwise silu
// v * rcp.approx(1 + __expf(-v)). Explicit _rn intrinsics keep nvcc from
// contracting a multiply and an add into an FMA across a rounding point.
//
// The layout is NCHW, not the TPU's polyphase planes (a Mosaic workaround).
// The TPU kernel keeps one segment's whole prefix in VMEM; that does not
// carry over: block 3's expand output alone is 96 x 48 x 256 f32 = 4.7 MB
// per segment, twenty times the 227 KB of shared memory a block may use,
// and the squeeze-excite mean needs the whole image before the project can
// run. So each block is two launches, with f32 scratch in device memory:
//   (a) expand_dw_kernel: one block per (output tile, segment) stages the
//       input tile with a one-pixel halo (times the stride) in shared
//       memory, then per chunk of 32 expanded channels computes the expand
//       + silu for the halo tile, the depthwise + silu from it, writes h2,
//       and writes the tile's per-channel sums of h2 (fixed-order, no
//       atomics, so the run is deterministic);
//   (b) se_project_kernel: every block of (pixel tile, segment) reduces the
//       tiles' sums to the mean, recomputes the tiny SE MLP (one warp per
//       dot product), then per chunk of 32 channels stages
//       h3 = T(h2 * gate) and the project weights, and runs the project +
//       bias + residual.
// With the stem that is 1 + 2k launches (13 at k = 6), all on the caller's
// stream.
//
// What bounds it on this card. At the full-width six-block prefix a segment
// needs about 0.45 GFLOP (~225 M multiply-adds, most in the 1x1 convs) and
// moves about 20 MB through device memory (h2 written once and read once in
// f32 per block, the T activations in and out), so at the HBM roofline it
// would take ~7 us and at the f32 SIMT peak ~7 us a segment. Both 1x1s run
// f32 FMAs from shared memory on register tiles of 4 pixels x 8 channels
// (one 16-byte load of pixels and two of weights feed 32 FMAs); the
// depthwise computes runs of 4 outputs along a row from registers. It is
// bound by instruction issue and by the halo recompute of the expand (the
// stride-2 blocks' tiles are 2 output rows high to fit shared memory).
// wgmma for the 1x1s, TMA tiles and fewer passes are later work.
//
// Plain C entry point, loaded with ctypes: it launches on the caller's
// stream, allocates nothing (activations ping-pong between two scratch
// buffers the caller hands in), and returns the first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Shared with ops/cuda/stage_prefix.py (_THREADS, _CHUNK, _PX, _CH, _RUN).
constexpr int kThreads = 256;
constexpr int kChunk = 32;                   // expand/project channels per pass
constexpr int kGroup = kThreads / kChunk;    // depthwise threads per channel
constexpr int kPx = 4;                       // 1x1 register tile: pixels
constexpr int kCh = 8;                       // 1x1 register tile: channels
constexpr int kRun = 4;                      // depthwise outputs per run

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float sigmoid_exact(float v) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
}

template <bool kFast>
__device__ __forceinline__ float silu(float v) {
  if (kFast) return __fmul_rn(v, rcp_approx(__fadd_rn(1.0f, __expf(-v))));
  return __fmul_rn(v, sigmoid_exact(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// acc[j][r] += x[j] * w[r] for one input channel: a 4 x 8 register tile fed
// by one 16-byte load of x and two of w, all from shared memory.
__device__ __forceinline__ void tile_fma(const float* x, const float* w,
                                         float (&acc)[kPx][kCh]) {
  const float4 xv = *reinterpret_cast<const float4*>(x);
  const float4 wa = *reinterpret_cast<const float4*>(w);
  const float4 wb = *reinterpret_cast<const float4*>(w + 4);
  const float xs[kPx] = {xv.x, xv.y, xv.z, xv.w};
  const float ws[kCh] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
  for (int j = 0; j < kPx; ++j) {
#pragma unroll
    for (int r = 0; r < kCh; ++r) acc[j][r] = fmaf(xs[j], ws[r], acc[j][r]);
  }
}

// Stem: out[n, c, oy, ox] = T(silu(sum_t w[c, t] * img[2oy-1+dy, 2ox-1+dx]
// + b[c])), zero outside the image. One thread per output pixel, all
// channels; the nine samples stay in registers.
template <typename T, bool kFast>
__global__ void __launch_bounds__(kThreads)
    stem_kernel(const T* __restrict__ img, const float* __restrict__ w,
                const float* __restrict__ b, T* __restrict__ out, int C, int H,
                int W, int Ho, int Wo) {
  const int hw = Ho * Wo;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = blockIdx.y;
  if (p >= hw) return;
  const int oy = p / Wo, ox = p - (p / Wo) * Wo;
  const T* src = img + static_cast<size_t>(n) * H * W;
  float v[9];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int iy = 2 * oy - 1 + dy, ix = 2 * ox - 1 + dx;
      v[dy * 3 + dx] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                           ? to_f32<T>(src[static_cast<size_t>(iy) * W + ix])
                           : 0.0f;
    }
  }
  T* dst = out + static_cast<size_t>(n) * C * hw + p;
  for (int c = 0; c < C; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < 9; ++t) acc = fmaf(w[c * 9 + t], v[t], acc);
    dst[static_cast<size_t>(c) * hw] = from_f32<T>(silu<kFast>(__fadd_rn(acc, b[c])));
  }
}

// The depthwise 3x3 of one channel over this lane's runs of kRun outputs
// along a row: each run reads its three input rows into registers once.
// hc is the channel's expanded halo tile (row pitch IW); writes
// silu(dw + bias) to dst (the channel's [Ho, Wo] plane) and returns the sum
// of what it wrote.
template <int kS, bool kFast>
__device__ __forceinline__ float depthwise_runs(const float* hc, int IW, const float* wt,
                                                float bias, float* dst, int oy0, int ox0,
                                                int Ho, int Wo, int TH, int TW, int lane) {
  constexpr int kSpan = kS * (kRun - 1) + 3;
  const int runs_x = TW / kRun;
  float sum = 0.0f;
  for (int q = lane; q < TH * runs_x; q += kGroup) {
    const int ly = q / runs_x, lx0 = (q - ly * runs_x) * kRun;
    const int oy = oy0 + ly;
    if (oy >= Ho) continue;
    float acc[kRun] = {};
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float* row = hc + (kS * ly + dy) * IW + kS * lx0;
      float v[kSpan];
#pragma unroll
      for (int t = 0; t < kSpan; ++t) v[t] = row[t];
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) acc[j] = fmaf(v[kS * j + dx], wt[dy * 3 + dx], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int ox = ox0 + lx0 + j;
      if (ox >= Wo) break;
      const float o = silu<kFast>(__fadd_rn(acc[j], bias));
      dst[oy * Wo + ox] = o;
      sum = __fadd_rn(sum, o);
    }
  }
  return sum;
}

// Launch (a): expand 1x1 + silu, depthwise 3x3 (stride 1 or 2) + silu.
// x [N, c_in, H, W] (T), w1 [c_mid, c_in] (T), wd [c_mid, 9]; writes
// h2 [N, c_mid, Ho, Wo] (f32) and part [N, n_tiles, c_mid], the tile's sums
// of h2 per channel. Grid: (n_tiles, N); output tile TH x TW, TW a multiple
// of kRun. Shared planes have a pitch rounded up to kPx floats, so every
// 4-pixel group is one aligned 16-byte load.
template <typename T, bool kFast>
__global__ void __launch_bounds__(kThreads)
    expand_dw_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ wd,
                     const float* __restrict__ bd, float* __restrict__ h2,
                     float* __restrict__ part, int c_in, int c_mid, int H, int W,
                     int Ho, int Wo, int stride, int TH, int TW) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int IH = stride * (TH - 1) + 3, IW = stride * (TW - 1) + 3;
  const int npx = IH * IW;
  const int pitch = (npx + kPx - 1) / kPx * kPx;
  float* s_x = smem;                    // [c_in][pitch]
  float* s_h = s_x + c_in * pitch;      // [kChunk][pitch]
  float* s_w = s_h + kChunk * pitch;    // [c_in][kChunk]
  const int tiles_x = (Wo + TW - 1) / TW;
  const int n_tiles = tiles_x * ((Ho + TH - 1) / TH);
  const int tile = blockIdx.x, n = blockIdx.y;
  const int oy0 = (tile / tiles_x) * TH, ox0 = (tile % tiles_x) * TW;
  const int iy0 = oy0 * stride - 1, ix0 = ox0 * stride - 1;
  const int hw = Ho * Wo;

  const T* xs = x + static_cast<size_t>(n) * c_in * H * W;
  for (int i = threadIdx.x; i < c_in * pitch; i += blockDim.x) {
    const int ci = i / pitch, p = i - ci * pitch;
    const int iy = iy0 + p / IW, ix = ix0 + p % IW;
    s_x[i] = (p < npx && iy >= 0 && iy < H && ix >= 0 && ix < W)
                 ? to_f32<T>(xs[(static_cast<size_t>(ci) * H + iy) * W + ix])
                 : 0.0f;
  }

  const int quads = pitch / kPx;
  for (int c0 = 0; c0 < c_mid; c0 += kChunk) {
    const int cm = min(kChunk, c_mid - c0);
    __syncthreads();  // the previous chunk is done with s_w and s_h
    for (int i = threadIdx.x; i < c_in * kChunk; i += blockDim.x) {
      const int ci = i / kChunk, c = i - ci * kChunk;
      s_w[i] = c < cm ? to_f32<T>(w1[static_cast<size_t>(c0 + c) * c_in + ci]) : 0.0f;
    }
    __syncthreads();

    // Expand over the halo tile: item = (group of kCh channels, kPx
    // pixels). Outside the image h1 is zero: the depthwise conv's padding.
    const int groups = (cm + kCh - 1) / kCh;
    for (int item = threadIdx.x; item < groups * quads; item += blockDim.x) {
      const int g = item / quads, p0 = (item - g * quads) * kPx;
      float acc[kPx][kCh] = {};
      for (int ci = 0; ci < c_in; ++ci) {
        tile_fma(s_x + ci * pitch + p0, s_w + ci * kChunk + g * kCh, acc);
      }
      bool inside[kPx];
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        const int p = p0 + j;
        const int iy = iy0 + p / IW, ix = ix0 + p % IW;
        inside[j] = p < npx && iy >= 0 && iy < H && ix >= 0 && ix < W;
      }
#pragma unroll
      for (int r = 0; r < kCh; ++r) {
        const int c = g * kCh + r;
        if (c >= cm) break;
        const float bias = b1[c0 + c];
        float4 h;
        h.x = inside[0] ? silu<kFast>(__fadd_rn(acc[0][r], bias)) : 0.0f;
        h.y = inside[1] ? silu<kFast>(__fadd_rn(acc[1][r], bias)) : 0.0f;
        h.z = inside[2] ? silu<kFast>(__fadd_rn(acc[2][r], bias)) : 0.0f;
        h.w = inside[3] ? silu<kFast>(__fadd_rn(acc[3][r], bias)) : 0.0f;
        *reinterpret_cast<float4*>(s_h + c * pitch + p0) = h;
      }
    }
    __syncthreads();

    // Depthwise: kGroup consecutive threads per channel, each a strided
    // share of the tile's runs; then their sums in a fixed shuffle order.
    const int c = threadIdx.x / kGroup, lane = threadIdx.x % kGroup;
    float sum = 0.0f;
    if (c < cm) {
      float wt[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) wt[t] = wd[(c0 + c) * 9 + t];
      float* dst = h2 + (static_cast<size_t>(n) * c_mid + c0 + c) * hw;
      sum = stride == 1
                ? depthwise_runs<1, kFast>(s_h + c * pitch, IW, wt, bd[c0 + c], dst, oy0,
                                           ox0, Ho, Wo, TH, TW, lane)
                : depthwise_runs<2, kFast>(s_h + c * pitch, IW, wt, bd[c0 + c], dst, oy0,
                                           ox0, Ho, Wo, TH, TW, lane);
    }
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      sum = __fadd_rn(sum, __shfl_down_sync(0xffffffffu, sum, off, kGroup));
    }
    if (c < cm && lane == 0) {
      part[(static_cast<size_t>(n) * n_tiles + tile) * c_mid + c0 + c] = sum;
    }
  }
}

// Launch (b): squeeze-excite gate, h3 = T(h2 * gate), project 1x1 + bias
// (+ residual). h2 [N, c_mid, hw], part [N, n_tiles, c_mid], se1
// [c_se, c_mid], se2 [c_mid, c_se], w3 [c_out, c_mid] (T), res
// [N, c_out, hw] (T) or null; out [N, c_out, hw] (T). Grid: (ceil(hw/P), N).
// Thread t owns the register tile (kPx pixels, kCh output channels) number
// t; P (a multiple of kPx) is chosen so that the tiles fit the block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    se_project_kernel(const float* __restrict__ h2, const float* __restrict__ part,
                      int n_tiles, const float* __restrict__ se1,
                      const float* __restrict__ bse1, const float* __restrict__ se2,
                      const float* __restrict__ bse2, const T* __restrict__ w3,
                      const float* __restrict__ b3, const T* __restrict__ res,
                      T* __restrict__ out, int c_mid, int c_se, int c_out, int hw,
                      int P) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int octs = (c_out + kCh - 1) / kCh, c_pad = octs * kCh;
  float* s_h3 = smem;                  // [kChunk][P]
  float* s_w = s_h3 + kChunk * P;      // [kChunk][c_pad], w3 transposed
  float* s_gate = s_w + kChunk * c_pad;  // [c_mid]
  float* s_mean = s_gate + c_mid;      // [c_mid]
  float* s_s1 = s_mean + c_mid;        // [c_se]
  const int n = blockIdx.y, p0 = blockIdx.x * P;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, n_warps = blockDim.x / 32;

  const float* pn = part + static_cast<size_t>(n) * n_tiles * c_mid;
  for (int c = threadIdx.x; c < c_mid; c += blockDim.x) {
    float s = 0.0f;
    for (int t = 0; t < n_tiles; ++t) s = __fadd_rn(s, pn[static_cast<size_t>(t) * c_mid + c]);
    s_mean[c] = __fdiv_rn(s, static_cast<float>(hw));
  }
  __syncthreads();
  for (int j = warp; j < c_se; j += n_warps) {
    float a = 0.0f;
    for (int c = lane; c < c_mid; c += 32) a = fmaf(se1[j * c_mid + c], s_mean[c], a);
    a = warp_sum(a);
    if (lane == 0) s_s1[j] = silu<false>(__fadd_rn(a, bse1[j]));
  }
  __syncthreads();
  for (int c = warp; c < c_mid; c += n_warps) {
    float a = 0.0f;
    for (int j = lane; j < c_se; j += 32) a = fmaf(se2[c * c_se + j], s_s1[j], a);
    a = warp_sum(a);
    if (lane == 0) s_gate[c] = sigmoid_exact(__fadd_rn(a, bse2[c]));
  }

  const int quads = P / kPx;
  const bool active = static_cast<int>(threadIdx.x) < quads * octs;
  const int oct = threadIdx.x / quads, q0 = (threadIdx.x - oct * quads) * kPx;
  float acc[kPx][kCh] = {};
  const float* hn = h2 + static_cast<size_t>(n) * c_mid * hw;
  for (int c0 = 0; c0 < c_mid; c0 += kChunk) {
    const int cm = min(kChunk, c_mid - c0);
    __syncthreads();  // s_gate is ready; the previous chunk is done
    for (int i = threadIdx.x; i < kChunk * P; i += blockDim.x) {
      const int c = i / P, p = p0 + i - c * P;
      s_h3[i] = (c < cm && p < hw)
                    ? to_f32<T>(from_f32<T>(__fmul_rn(hn[static_cast<size_t>(c0 + c) * hw + p],
                                                      s_gate[c0 + c])))
                    : 0.0f;
    }
    for (int i = threadIdx.x; i < kChunk * c_pad; i += blockDim.x) {
      const int c = i / c_pad, co = i - c * c_pad;
      s_w[i] = (c < cm && co < c_out) ? to_f32<T>(w3[static_cast<size_t>(co) * c_mid + c0 + c])
                                      : 0.0f;
    }
    __syncthreads();
    if (active) {
      for (int c = 0; c < cm; ++c) tile_fma(s_h3 + c * P + q0, s_w + c * c_pad + oct * kCh, acc);
    }
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < kCh; ++r) {
    const int co = oct * kCh + r;
    if (co >= c_out) break;
    const float bias = b3[co];
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      const int p = p0 + q0 + j;
      if (p >= hw) break;
      const size_t o = (static_cast<size_t>(n) * c_out + co) * hw + p;
      float y = __fadd_rn(acc[j][r], bias);
      if (res != nullptr) y = __fadd_rn(y, to_f32<T>(res[o]));
      out[o] = from_f32<T>(y);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// geoms: per block c_in, c_mid, c_se, c_out, stride, residual, TH, TW, P.
// ptrs: stem_w, stem_b, then per block w1, b1, wd, bd, se1, bse1, se2,
// bse2, w3, b3.
template <typename T, bool kFast>
int run(int n_blocks, const int* geoms, const void* const* ptrs, const void* img,
        void* out, void* act0, void* act1, float* h2, float* part, int N,
        int C_stem, int H, int W, cudaStream_t stream) {
  int h = (H - 1) / 2 + 1, w = (W - 1) / 2 + 1;
  T* cur = static_cast<T*>(act0);
  {
    const dim3 grid((h * w + kThreads - 1) / kThreads, N);
    stem_kernel<T, kFast><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(img), static_cast<const float*>(ptrs[0]),
        static_cast<const float*>(ptrs[1]), cur, C_stem, H, W, h, w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int b = 0; b < n_blocks; ++b) {
    const int* g = geoms + 9 * b;
    const int c_in = g[0], c_mid = g[1], c_se = g[2], c_out = g[3];
    const int stride = g[4], residual = g[5], TH = g[6], TW = g[7], P = g[8];
    const void* const* wp = ptrs + 2 + 10 * b;
    const int ho = (h - 1) / stride + 1, wo = (w - 1) / stride + 1;
    const int n_tiles = ((ho + TH - 1) / TH) * ((wo + TW - 1) / TW);
    T* dst = b == n_blocks - 1 ? static_cast<T*>(out)
                               : (cur == static_cast<T*>(act0) ? static_cast<T*>(act1)
                                                               : static_cast<T*>(act0));
    const int IH = stride * (TH - 1) + 3, IW = stride * (TW - 1) + 3;
    const size_t pitch = static_cast<size_t>(IH * IW + kPx - 1) / kPx * kPx;
    const size_t smem_a = sizeof(float) * (static_cast<size_t>(c_in) * pitch +
                                           static_cast<size_t>(kChunk) * pitch +
                                           static_cast<size_t>(c_in) * kChunk);
    cudaError_t err = set_smem(expand_dw_kernel<T, kFast>, smem_a);
    if (err != cudaSuccess) return static_cast<int>(err);
    expand_dw_kernel<T, kFast><<<dim3(n_tiles, N), kThreads, smem_a, stream>>>(
        cur, static_cast<const T*>(wp[0]), static_cast<const float*>(wp[1]),
        static_cast<const float*>(wp[2]), static_cast<const float*>(wp[3]), h2, part,
        c_in, c_mid, h, w, ho, wo, stride, TH, TW);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    const int hw = ho * wo;
    const int c_pad = (c_out + kCh - 1) / kCh * kCh;
    const size_t smem_b = sizeof(float) * (static_cast<size_t>(kChunk) * (P + c_pad) +
                                           2 * c_mid + c_se);
    err = set_smem(se_project_kernel<T>, smem_b);
    if (err != cudaSuccess) return static_cast<int>(err);
    se_project_kernel<T><<<dim3((hw + P - 1) / P, N), kThreads, smem_b, stream>>>(
        h2, part, n_tiles, static_cast<const float*>(wp[4]),
        static_cast<const float*>(wp[5]), static_cast<const float*>(wp[6]),
        static_cast<const float*>(wp[7]), static_cast<const T*>(wp[8]),
        static_cast<const float*>(wp[9]), residual ? cur : nullptr, dst, c_mid, c_se,
        c_out, hw, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cur = dst;
    h = ho;
    w = wo;
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (image, 1x1 weights, activations, out).
extern "C" int bn_stage_stack_forward(int dtype, int fast_act, int n_blocks,
                                      const int* geoms, const void* const* ptrs,
                                      const void* img, void* out, void* act0,
                                      void* act1, void* h2, void* part, int N,
                                      int C_stem, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* h = static_cast<float*>(h2);
  float* pt = static_cast<float*>(part);
  if (dtype == 0) {
    return fast_act ? run<float, true>(n_blocks, geoms, ptrs, img, out, act0, act1, h, pt,
                                       N, C_stem, H, W, s)
                    : run<float, false>(n_blocks, geoms, ptrs, img, out, act0, act1, h,
                                        pt, N, C_stem, H, W, s);
  }
  return fast_act ? run<__nv_bfloat16, true>(n_blocks, geoms, ptrs, img, out, act0, act1,
                                             h, pt, N, C_stem, H, W, s)
                  : run<__nv_bfloat16, false>(n_blocks, geoms, ptrs, img, out, act0,
                                              act1, h, pt, N, C_stem, H, W, s);
}
