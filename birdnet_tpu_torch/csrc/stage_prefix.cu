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
// run. So each block is an expand + depthwise pass and a project pass, with
// h2 in f32 scratch in device memory, written once and read once (the f32
// width is the contract's:
// h3 = T(h2 * gate)); recomputing the expand and the depthwise in the
// second pass instead would save that round trip (~4.4 us a segment at the
// HBM rate) but double the silu epilogues on the special-function units
// (~2.6 us), the larger share of what is left, so the round trip stays.
// With the stem that is 1 + 3k launches in bf16 (19 at k = 6; the gate is
// its own launch) and 1 + 2k in f32, all on the caller's stream.
//
// bf16 (the fast/bf16 lowerings), on the tensor cores. Both 1x1 convs are
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 products fed by
// ldmatrix from bf16 shared memory: bf16 x bf16 with f32 sums, the
// contract's product, so no rounding point moves. mma.sync rather than
// wgmma: its 16 x 8 tiles fit these narrow products (K = c_in 24-80, N =
// c_out 24-80) without wgmma's 64-row tiles and descriptor layouts, and at
// the bf16 peak both products take ~0.4 us of a segment, so the MMA rate
// does not bound this kernel; the silu epilogues, the f32 depthwise and
// h2's round trip do.
//   (a) expand_dw_mma_kernel: grid (output tile, group of CG expanded
//       channels (32 or 64), segment). The CTA stages the input tile with
//       its halo in bf16 (exact: the block input is bf16) as channel planes,
//       K = c_in zero-padded to 16, which ldmatrix.trans reads as the
//       row-major A operand (M = halo pixels), and the group's expand weights
//       once as the B operand (N = channels, K-contiguous rows, so plain
//       ldmatrix).
//       Per chunk of CH channels (16 or 32) the warps take 16-pixel M tiles:
//       the MMAs, then + bias, silu, zero outside the image on the
//       accumulators, into an f32 h1 plane per channel; then the depthwise
//       + silu from h1 writes h2 and the tile's per-channel sums of h2
//       (fixed order, no atomics: the run is deterministic). Staging bf16
//       instead of f32 frees shared memory for tall tiles, so the expand's
//       recompute over the halo stays at 1.2 times the image or below
//       (ops/cuda/stage_prefix.py::launch_plan picks the tile).
//   se_gate_kernel: one CTA per segment reduces the tiles' sums to the
//       mean and runs the tiny SE MLP once, each dot product as 32-wide
//       partial sums with their weights loaded at once (per CTA of (b), as
//       the first port did, it was a chain of dependent loads in every
//       CTA).
//   (b) se_project_mma_kernel: grid (128-pixel tile, group of 128 output
//       channels, segment). The CTA starts the cp.async copy of h2's first
//       32 channels and stages the project weights once (B operand, K =
//       c_mid padded to 16, N = c_out padded to 16); then per 32 channels
//       it starts the next stage's copy, turns the landed stage into
//       h3 = bf16(h2 * gate) in the A layout and runs the MMAs while the
//       copy is in flight; the epilogue adds the bias on the accumulators,
//       and the residual on the way out through shared memory (coalesced
//       NCHW stores).
//   Staging reads 16 bytes a load (the image rows and weight rows are
//   multiples of 8 elements at v2.4's widths; 2-byte loads otherwise), so
//   that enough bytes are in flight: with 2-byte loads the staging was a
//   chain of latencies.
//
// f32 (T = float; only the public function and chip_smoke.py's f32 case
// reach it, no lowering does) keeps the SIMT kernels of the first port
// (expand_dw_kernel, se_project_kernel): f32 FMAs on 4 x 8 register tiles
// from f32 shared memory, as the f32 variants of B1 and B2 keep SIMT FMAs.
//
// Plain C entry point, loaded with ctypes: it launches on the caller's
// stream, allocates nothing (activations ping-pong between two scratch
// buffers the caller hands in), and returns the first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "sm90.cuh"

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
// along a row (G lanes share the channel): each run reads its three input
// rows into registers once.
// hc is the channel's expanded halo tile (row pitch IW); writes
// silu(dw + bias) to dst (the channel's [Ho, Wo] plane) and returns the sum
// of what it wrote.
template <int kS, bool kFast, int G = kGroup>
__device__ __forceinline__ float depthwise_runs(const float* hc, int IW, const float* wt,
                                                float bias, float* dst, int oy0, int ox0,
                                                int Ho, int Wo, int TH, int TW, int lane,
                                                bool vec_store = false) {
  constexpr int kSpan = kS * (kRun - 1) + 3;
  const int runs_x = TW / kRun;
  const bool pow2 = (runs_x & (runs_x - 1)) == 0;  // a shift, not a division
  const int shift = __ffs(runs_x) - 1;
  float sum = 0.0f;
  for (int q = lane; q < TH * runs_x; q += G) {
    const int ly = pow2 ? q >> shift : q / runs_x, lx0 = (q - ly * runs_x) * kRun;
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
    if (vec_store && ox0 + lx0 + kRun <= Wo) {
      // One 16-byte store (Wo and the plane pitch are multiples of 4).
      float o[kRun];
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        o[j] = silu<kFast>(__fadd_rn(acc[j], bias));
        sum = __fadd_rn(sum, o[j]);
      }
      *reinterpret_cast<float4*>(dst + oy * Wo + ox0 + lx0) = make_float4(o[0], o[1], o[2], o[3]);
      continue;
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

// ---------------------------------------------------------------------------
// bf16: the 1x1 convs on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// Shared with ops/cuda/stage_prefix.py (_WARPS, _PROJ_PX, _PROJ_KC,
// _PROJ_COLS): warps per CTA; pixels per CTA of launch (b) (one 16-row M
// tile per warp), its channels per cp.async stage and its output channels
// per CTA. The gate kernel's threads. The input tile's 16-byte loads in
// flight per thread.
constexpr int kWarps = kThreads / 32;
constexpr int kGateThreads = 512;
constexpr int kStageLoads = 8;
constexpr int kProjPx = 16 * kWarps;
constexpr int kProjKc = 32;
constexpr int kProjCols = 128;

__host__ __device__ __forceinline__ int round_up(int n, int m) { return (n + m - 1) / m * m; }

// The pitch (elements) of bf16 rows that ldmatrix reads: an odd multiple of
// 8 elements (16 bytes), so that the 8 rows of one 8 x 8 matrix fall on
// distinct bank groups.
__host__ __device__ __forceinline__ int mma_pitch(int n) {
  n = round_up(n, 8);
  return (n / 8) % 2 ? n : n + 8;
}

// The pitch (floats) of the f32 planes written from the accumulators: 4 mod
// 8, so that a warp's (channel 2t, pixel g) stores hit 32 distinct banks.
__host__ __device__ __forceinline__ int acc_pitch(int n) { return round_up(n, 8) + 4; }

// Launch (a)'s shared memory: the input tile [K][xp] bf16 (K = c_in padded
// to 16, M = the halo pixels padded to 16), the group's weights [CG][wp]
// bf16, one chunk of h1 [CH][hp] f32 (each a multiple of 16 bytes), then
// one bit per halo pixel: inside the image.
struct ExpandSmem {
  int k, m, xp, wp, hp;
  size_t x_bytes, w_bytes, h_bytes, total;
};

__host__ __device__ __forceinline__ ExpandSmem expand_smem(int c_in, int stride, int TH,
                                                           int TW, int CH, int CG) {
  ExpandSmem s;
  const int IH = stride * (TH - 1) + 3, IW = stride * (TW - 1) + 3;
  s.k = round_up(c_in, 16);
  s.m = round_up(IH * IW, 16);
  s.xp = mma_pitch(s.m);
  s.wp = mma_pitch(s.k);
  s.hp = acc_pitch(s.m);
  s.x_bytes = sizeof(bf16) * s.k * s.xp;
  s.w_bytes = sizeof(bf16) * static_cast<size_t>(CG) * s.wp;
  s.h_bytes = sizeof(float) * static_cast<size_t>(CH) * s.hp;
  s.total = s.x_bytes + s.w_bytes + s.h_bytes + sizeof(unsigned) * (s.m / 32 + 1);
  return s;
}

// Launch (b)'s: the project weights [cols][wp] bf16 (K = c_mid padded to
// 16), which the [cols][kProjPx + 4] f32 output tile reuses; two cp.async
// stages of h2 [kProjKc][kProjPx] f32; h3 [kProjKc][ap] bf16; the gate
// (c_mid, f32). cols = the output channels of one CTA, padded to 16.
struct ProjectSmem {
  int k, wp, ap;
  size_t w_bytes, stage_bytes, a_bytes, total;
};

__host__ __device__ __forceinline__ ProjectSmem project_smem(int c_mid, int cols) {
  ProjectSmem s;
  s.k = round_up(c_mid, 16);
  s.wp = mma_pitch(s.k);
  s.ap = mma_pitch(kProjPx);
  const size_t w = sizeof(bf16) * static_cast<size_t>(cols) * s.wp;
  const size_t o = sizeof(float) * static_cast<size_t>(cols) * (kProjPx + 4);
  s.w_bytes = w > o ? w : o;
  s.stage_bytes = sizeof(float) * 2 * kProjKc * kProjPx;
  s.a_bytes = sizeof(bf16) * kProjKc * s.ap;
  s.total = s.w_bytes + s.stage_bytes + s.a_bytes +
            sizeof(float) * static_cast<size_t>(round_up(c_mid, 4));
  return s;
}

// Element t (0-7) of 8 bf16 packed low-first in a uint4, as raw bits.
__device__ __forceinline__ unsigned short bf16_bits(const uint4& v, int t) {
  const unsigned w = t < 2 ? v.x : (t < 4 ? v.y : (t < 6 ? v.z : v.w));
  return static_cast<unsigned short>((t & 1) ? w >> 16 : w & 0xffffu);
}

// rows x k bf16 weights (row-major, row length ld) into shared rows of pitch
// `pitch`, zero past `valid` rows and past ld columns, k a multiple of 8:
// 16-byte loads where ld is a multiple of 8, else 2-byte ones.
__device__ __forceinline__ void stage_weights(bf16* dst, int pitch, const bf16* src, int ld,
                                              int rows, int valid, int k) {
  const bf16 zero = __float2bfloat16_rn(0.0f);
  if (ld % 8 == 0) {
    const int kc = k / 8;
    for (int u = threadIdx.x; u < rows * kc; u += kThreads) {
      const int r = u / kc, k8 = (u - r * kc) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid && k8 < ld) {
        v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * ld + k8);
      }
      *reinterpret_cast<uint4*>(dst + r * pitch + k8) = v;
    }
  } else {
    for (int i = threadIdx.x; i < rows * k; i += kThreads) {
      const int r = i / k, c = i - r * k;
      dst[r * pitch + c] = r < valid && c < ld ? src[static_cast<size_t>(r) * ld + c] : zero;
    }
  }
}

// Four 8 x 8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. ldsm_x4_t transposes each matrix: from planes
// stored [k][m] it yields the row-major A fragment of an m16k16 tile.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16, row-major fragment) x b (16 x 8, col-major fragment):
// bf16 products summed in f32. d[0..1] are row g = lane / 4, columns 2t and
// 2t + 1 (t = lane % 4); d[2..3] the same columns of row g + 8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A lane's ldmatrix offsets: for the A operand (x4.trans over [k][m]
// planes: matrices (m0, k0), (m0 + 8, k0), (m0, k0 + 8), (m0 + 8, k0 + 8))
// the row k and column m; for two n-tiles of the B operand (x4 over [n][k]
// rows: matrices (n0, k0), (n0, k0 + 8), (n0 + 8, k0), (n0 + 8, k0 + 8))
// the row n and column k.
struct LdsmLane {
  int a_k, a_m, b_n, b_k;
  __device__ __forceinline__ explicit LdsmLane(int lane)
      : a_k((lane & 7) + ((lane >> 4) & 1) * 8),
        a_m(((lane >> 3) & 1) * 8),
        b_n((lane & 7) + ((lane >> 4) & 1) * 8),
        b_k(((lane >> 3) & 1) * 8) {}
};

// Launch (a) in bf16: expand 1x1 on the tensor cores + silu, depthwise 3x3
// (stride 1 or 2) + silu. x [N, c_in, H, W], w1 [c_mid, c_in]; writes h2
// [N, c_mid, hw_pitch] (f32 planes of Ho x Wo) and part [N, n_tiles,
// c_mid]. Grid (n_tiles, ceil(c_mid / CG), N); output tile TH x TW (TW a
// multiple of kRun); NT = CH / 8 n-tiles per chunk (CG a multiple of CH).
template <int NT, bool kFast>
__global__ void __launch_bounds__(kThreads, 2)
    expand_dw_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                         const float* __restrict__ b1, const float* __restrict__ wd,
                         const float* __restrict__ bd, float* __restrict__ h2,
                         float* __restrict__ part, int c_in, int c_mid, int H, int W, int Ho,
                         int Wo, int hw_pitch, int stride, int TH, int TW, int CG) {
  // Where W % 8 == 0 every image row starts 16 bytes aligned: the input
  // tile is staged in 16-byte loads, kStageLoads in flight per thread.
  constexpr int CH = NT * 8;
  constexpr int G = kThreads / CH;  // depthwise threads per channel
  static_assert(NT % 2 == 0, "n-tiles go in pairs (one ldmatrix.x4 each)");
  extern __shared__ float4 smem4[];
  const ExpandSmem L = expand_smem(c_in, stride, TH, TW, CH, CG);
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  bf16* s_x = reinterpret_cast<bf16*>(base);                            // [k][xp]
  bf16* s_w = reinterpret_cast<bf16*>(base + L.x_bytes);                // [CG][wp]
  float* s_h = reinterpret_cast<float*>(base + L.x_bytes + L.w_bytes);  // [CH][hp]
  unsigned* s_in = reinterpret_cast<unsigned*>(base + L.x_bytes + L.w_bytes + L.h_bytes);
  const int IH = stride * (TH - 1) + 3, IW = stride * (TW - 1) + 3;
  const int npx = IH * IW;
  const int tiles_x = (Wo + TW - 1) / TW;
  const int n_tiles = tiles_x * ((Ho + TH - 1) / TH);
  const int tile = blockIdx.x, g0 = blockIdx.y * CG, n = blockIdx.z;
  const int cg = min(CG, c_mid - g0);
  const int oy0 = (tile / tiles_x) * TH, ox0 = (tile % tiles_x) * TW;
  const int iy0 = oy0 * stride - 1, ix0 = ox0 * stride - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16 zero = __float2bfloat16_rn(0.0f);

  // The input tile as halo planes: zero outside the image and for the
  // padding channels; then zero the pixel padding of every plane.
  const bf16* xs = x + static_cast<size_t>(n) * c_in * H * W;
  if (W % 8 == 0) {
    // Units of 8 columns from xa, a multiple of 8: a halo row spans nch.
    unsigned short* sx = reinterpret_cast<unsigned short*>(s_x);
    const int xa = ix0 & ~7;
    const int nch = (ix0 + IW - xa + 7) >> 3;
    const int units = L.k * IH * nch;
    for (int u0 = threadIdx.x; u0 < units; u0 += kStageLoads * kThreads) {
      uint4 v[kStageLoads];
      int rows[kStageLoads], gxs[kStageLoads];
#pragma unroll
      for (int j = 0; j < kStageLoads; ++j) {
        const int u = u0 + j * kThreads;
        v[j] = make_uint4(0u, 0u, 0u, 0u);
        rows[j] = u / nch;
        gxs[j] = xa + 8 * (u - rows[j] * nch);
        const int c = rows[j] / IH, iy = iy0 + rows[j] - c * IH;
        if (u < units && c < c_in && iy >= 0 && iy < H && gxs[j] >= 0 && gxs[j] < W) {
          v[j] = *reinterpret_cast<const uint4*>(xs + (static_cast<size_t>(c) * H + iy) * W +
                                                 gxs[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kStageLoads; ++j) {
        if (u0 + j * kThreads < units) {
          const int c = rows[j] / IH, r = rows[j] - c * IH;
          const int at = c * L.xp + r * IW - ix0;  // + the column
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const int gx = gxs[j] + t;
            if (gx >= ix0 && gx < ix0 + IW) sx[at + gx] = bf16_bits(v[j], t);
          }
        }
      }
    }
  } else {
    for (int row = warp; row < L.k * IH; row += kWarps) {
      const int c = row / IH, r = row - c * IH, iy = iy0 + r;
      bf16* dst = s_x + c * L.xp + r * IW;
      if (c < c_in && iy >= 0 && iy < H) {
        const bf16* src = xs + (static_cast<size_t>(c) * H + iy) * W;
        for (int q = lane; q < IW; q += 32) {
          const int ix = ix0 + q;
          dst[q] = ix >= 0 && ix < W ? src[ix] : zero;
        }
      } else {
        for (int q = lane; q < IW; q += 32) dst[q] = zero;
      }
    }
  }
  const int pad = L.m - npx;
  for (int i = threadIdx.x; i < L.k * pad; i += kThreads) {
    const int c = i / pad;
    s_x[c * L.xp + npx + (i - c * pad)] = zero;
  }
  // The group's weights, zero past c_in and past the group's channels.
  stage_weights(s_w, L.wp, w1 + static_cast<size_t>(g0) * c_in, c_in, CG, cg, L.k);
  // Which halo pixels lie inside the image, a bit each (one division per
  // pixel here, none in the epilogues).
  for (int p0 = warp * 32; p0 < L.m; p0 += kThreads) {
    const int p = p0 + lane;
    const int r = p / IW, iy = iy0 + r, ix = ix0 + p - r * IW;
    const unsigned bits =
        __ballot_sync(0xffffffffu, p < npx && iy >= 0 && iy < H && ix >= 0 && ix < W);
    if (lane == 0) s_in[p0 / 32] = bits;
  }

  const LdsmLane ll(lane);
  const int gq = lane >> 2, tq = (lane & 3) * 2;
  const int mtiles = L.m / 16;
  for (int c0 = 0; c0 < cg; c0 += CH) {
    __syncthreads();  // staging is done; the previous chunk's depthwise is done with s_h
    float bias[NT][2];  // this thread's channels 2t, 2t + 1 of each n-tile
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + j * 8 + tq + e;
        bias[j][e] = c < cg ? b1[g0 + c] : 0.0f;
      }
    }
    for (int mt = warp; mt < mtiles; mt += kWarps) {
      const int m0 = mt * 16;
      float acc[NT][4] = {};
      for (int k0 = 0; k0 < L.k; k0 += 16) {
        unsigned a[4];
        ldsm_x4_t(a, s_x + (k0 + ll.a_k) * L.xp + m0 + ll.a_m);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          unsigned b[4];
          ldsm_x4(b, s_w + (c0 + j * 8 + ll.b_n) * L.wp + k0 + ll.b_k);
          mma_bf16(acc[j], a, b[0], b[1]);
          mma_bf16(acc[j + 1], a, b[2], b[3]);
        }
      }
      // Outside the image h1 is zero: the depthwise conv's padding.
      const unsigned word = s_in[m0 / 32] >> (m0 % 32);
      const bool inside[2] = {((word >> gq) & 1u) != 0, ((word >> (gq + 8)) & 1u) != 0};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + tq + (e & 1), p = m0 + gq + 8 * (e >> 1);
          s_h[c * L.hp + p] =
              inside[e >> 1] ? silu<kFast>(__fadd_rn(acc[j][e], bias[j][e & 1])) : 0.0f;
        }
      }
    }
    __syncthreads();

    // Depthwise: G consecutive threads per channel, each a strided share of
    // the tile's runs; then their sums in a fixed shuffle order.
    const int cm = min(CH, cg - c0);
    const int c = threadIdx.x / G, gl = threadIdx.x % G;
    const int cc = g0 + c0 + c;
    float sum = 0.0f;
    if (c < cm) {
      float wt[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) wt[t] = wd[cc * 9 + t];
      float* dst = h2 + (static_cast<size_t>(n) * c_mid + cc) * hw_pitch;
      sum = stride == 1
                ? depthwise_runs<1, kFast, G>(s_h + c * L.hp, IW, wt, bd[cc], dst, oy0, ox0, Ho,
                                              Wo, TH, TW, gl, Wo % 4 == 0)
                : depthwise_runs<2, kFast, G>(s_h + c * L.hp, IW, wt, bd[cc], dst, oy0, ox0, Ho,
                                              Wo, TH, TW, gl, Wo % 4 == 0);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      sum = __fadd_rn(sum, __shfl_down_sync(0xffffffffu, sum, off, G));
    }
    if (c < cm && gl == 0) part[(static_cast<size_t>(n) * n_tiles + tile) * c_mid + cc] = sum;
  }
}

// partial[row * slices + q] = sum over k in slice q (32 wide) of W[row, k] * v[k]
// for W [rows, K] row-major in device memory and v in shared memory: one
// (row, slice) per thread, its 32 weights loaded at once (8 x 16 bytes
// where K is a multiple of 4), so that a dot product costs one load
// latency, not one per warp reduction step.
__device__ __forceinline__ void matvec_partials(const float* __restrict__ W, const float* v,
                                                int rows, int K, float* partial) {
  const int slices = (K + 31) / 32;
  for (int item = threadIdx.x; item < rows * slices; item += blockDim.x) {
    const int row = item / slices, k0 = (item - row * slices) * 32;
    const int kn = min(32, K - k0);
    const float* w = W + static_cast<size_t>(row) * K + k0;
    float a = 0.0f;
    if (K % 4 == 0) {
      float4 q[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        q[t] = 4 * t < kn ? *reinterpret_cast<const float4*>(w + 4 * t) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (4 * t < kn) {
          a = fmaf(q[t].x, v[k0 + 4 * t], a);
          a = fmaf(q[t].y, v[k0 + 4 * t + 1], a);
          a = fmaf(q[t].z, v[k0 + 4 * t + 2], a);
          a = fmaf(q[t].w, v[k0 + 4 * t + 3], a);
        }
      }
    } else {
#pragma unroll 8
      for (int k = 0; k < kn; ++k) a = fmaf(w[k], v[k0 + k], a);
    }
    partial[item] = a;
  }
}

// The squeeze-excite gate of one (segment, block), computed once: the
// tiles' per-channel sums of h2 (in tile order) -> mean -> s1 = silu(se1 @
// mean + bse1) -> gate = sigmoid(se2 @ s1 + bse2), f32 with the exact
// sigmoid; each dot product as 32-wide partial sums added in slice order.
// part [N, n_tiles, c_mid]; gate [N, c_mid]. Grid (N); shared mean
// [c_mid], s1 [c_se] and the partial sums.
__global__ void __launch_bounds__(kGateThreads)
    se_gate_kernel(const float* __restrict__ part, int n_tiles,
                   const float* __restrict__ se1, const float* __restrict__ bse1,
                   const float* __restrict__ se2, const float* __restrict__ bse2,
                   float* __restrict__ gate, int c_mid, int c_se, int hw) {
  extern __shared__ float4 smem4[];
  float* s_mean = reinterpret_cast<float*>(smem4);
  float* s_s1 = s_mean + c_mid;
  float* s_part = s_s1 + c_se;
  const int n = blockIdx.x;
  const float* pn = part + static_cast<size_t>(n) * n_tiles * c_mid;
  for (int c = threadIdx.x; c < c_mid; c += kGateThreads) {
    float s = 0.0f;
#pragma unroll 8
    for (int t = 0; t < n_tiles; ++t) s = __fadd_rn(s, pn[static_cast<size_t>(t) * c_mid + c]);
    s_mean[c] = __fdiv_rn(s, static_cast<float>(hw));
  }
  __syncthreads();
  const int sl1 = (c_mid + 31) / 32, sl2 = (c_se + 31) / 32;
  matvec_partials(se1, s_mean, c_se, c_mid, s_part);
  __syncthreads();
  for (int j = threadIdx.x; j < c_se; j += kGateThreads) {
    float a = 0.0f;
    for (int q = 0; q < sl1; ++q) a = __fadd_rn(a, s_part[j * sl1 + q]);
    s_s1[j] = silu<false>(__fadd_rn(a, bse1[j]));
  }
  __syncthreads();
  matvec_partials(se2, s_s1, c_mid, c_se, s_part);
  __syncthreads();
  for (int c = threadIdx.x; c < c_mid; c += kGateThreads) {
    float a = 0.0f;
    for (int q = 0; q < sl2; ++q) a = __fadd_rn(a, s_part[c * sl2 + q]);
    gate[static_cast<size_t>(n) * c_mid + c] = sigmoid_exact(__fadd_rn(a, bse2[c]));
  }
}

// The f32 value of the low / high bf16 of a packed pair.
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// Launch (b) in bf16: h3 = bf16(h2 * gate), project 1x1 on the tensor cores
// + bias (+ residual). h2 [N, c_mid, hw_pitch], gate [N, c_mid], w3 [c_out,
// c_mid], res [N, c_out, hw] or null; out [N, c_out, hw]. Grid
// (ceil(hw / kProjPx), ceil(c_out / kProjCols), N); warp w computes pixels
// 16w..16w+15 of the tile for the CTA's output channels, at most kMaxNt
// n-tiles of 8 (the widest CTA's channels padded to 16, over 8: registers
// follow the block's width).
template <int kMaxNt>
__global__ void __launch_bounds__(kThreads, 2)
    se_project_mma_kernel(const float* __restrict__ h2, int hw_pitch,
                          const float* __restrict__ gate, const bf16* __restrict__ w3,
                          const float* __restrict__ b3, const bf16* __restrict__ res,
                          bf16* __restrict__ out, int c_mid, int c_out, int hw) {
  static_assert(kMaxNt % 2 == 0 && kMaxNt * 8 <= kProjCols, "n-tiles go in pairs");
  extern __shared__ float4 smem4[];
  const int cols_max = min(kProjCols, round_up(c_out, 16));
  const ProjectSmem L = project_smem(c_mid, cols_max);
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  bf16* s_w = reinterpret_cast<bf16*>(base);                    // [cols][wp]
  float* s_o = reinterpret_cast<float*>(base);                  // [cols][kProjPx + 4], later
  float* s_stage = reinterpret_cast<float*>(base + L.w_bytes);  // [2][kProjKc][kProjPx]
  bf16* s_a = reinterpret_cast<bf16*>(base + L.w_bytes + L.stage_bytes);  // [kProjKc][ap]
  float* s_gate = reinterpret_cast<float*>(base + L.w_bytes + L.stage_bytes + L.a_bytes);
  const int n = blockIdx.z, p0 = blockIdx.x * kProjPx, n0 = blockIdx.y * kProjCols;
  const int cols = min(kProjCols, round_up(c_out - n0, 16));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // h2's channels c0..c0 + kProjKc - 1 for the tile's pixels into stage s,
  // 16 bytes a copy (hw_pitch and p0 are multiples of 4), zero past c_mid
  // and past hw.
  const float* hn = h2 + static_cast<size_t>(n) * c_mid * hw_pitch;
  auto load_stage = [&](int s, int c0) {
    float* dst = s_stage + s * kProjKc * kProjPx;
    for (int i = threadIdx.x; i < kProjKc * kProjPx / 4; i += kThreads) {
      const int k = i / (kProjPx / 4), q = (i - k * (kProjPx / 4)) * 4;
      const int c = c0 + k, p = p0 + q;
      const bool ok = c < c_mid && p < hw;
      const int bytes = ok ? min(16, 4 * (hw - p)) : 0;
      cp_async16(dst + k * kProjPx + q, ok ? hn + static_cast<size_t>(c) * hw_pitch + p : hn,
                 bytes);
    }
    cp_async_commit();
  };
  load_stage(0, 0);
  stage_weights(s_w, L.wp, w3 + static_cast<size_t>(n0) * c_mid, c_mid, cols, c_out - n0, L.k);
  for (int c = threadIdx.x; c < c_mid; c += kThreads) s_gate[c] = gate[static_cast<size_t>(n) * c_mid + c];

  const LdsmLane ll(lane);
  const int nt = cols / 8;
  const int chunks = (L.k + kProjKc - 1) / kProjKc;
  float acc[kMaxNt][4] = {};
  for (int ch = 0; ch < chunks; ++ch) {
    const int c0 = ch * kProjKc;
    if (ch + 1 < chunks) {
      load_stage((ch + 1) & 1, c0 + kProjKc);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // Stage ch has landed for every thread; s_gate is ready; the previous
    // chunk's MMAs are done with s_a.
    __syncthreads();
    const float* st = s_stage + (ch & 1) * kProjKc * kProjPx;
    for (int i = threadIdx.x; i < kProjKc * kProjPx / 4; i += kThreads) {
      const int k = i / (kProjPx / 4), q = (i - k * (kProjPx / 4)) * 4;
      const float gate = c0 + k < c_mid ? s_gate[c0 + k] : 0.0f;
      const float4 v = *reinterpret_cast<const float4*>(st + k * kProjPx + q);
      __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(s_a + k * L.ap + q);
      d[0] = __floats2bfloat162_rn(__fmul_rn(v.x, gate), __fmul_rn(v.y, gate));
      d[1] = __floats2bfloat162_rn(__fmul_rn(v.z, gate), __fmul_rn(v.w, gate));
    }
    __syncthreads();
    for (int kk = 0; kk < kProjKc && c0 + kk < L.k; kk += 16) {
      unsigned a[4];
      ldsm_x4_t(a, s_a + (kk + ll.a_k) * L.ap + warp * 16 + ll.a_m);
#pragma unroll
      for (int j = 0; j < kMaxNt; j += 2) {
        if (j < nt) {
          unsigned b[4];
          ldsm_x4(b, s_w + (j * 8 + ll.b_n) * L.wp + c0 + kk + ll.b_k);
          mma_bf16(acc[j], a, b[0], b[1]);
          mma_bf16(acc[j + 1], a, b[2], b[3]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with s_w: it holds the output tile now

  const int gq = lane >> 2, tq = (lane & 3) * 2;
  constexpr int kOp = kProjPx + 4;
#pragma unroll
  for (int j = 0; j < kMaxNt; ++j) {
    if (j < nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + tq + (e & 1), p = warp * 16 + gq + 8 * (e >> 1);
        const float bias = n0 + col < c_out ? b3[n0 + col] : 0.0f;
        s_o[col * kOp + p] = __fadd_rn(acc[j][e], bias);
      }
    }
  }
  __syncthreads();
  const int cols_here = min(cols, c_out - n0);
  if (hw % 8 == 0) {
    // 8 pixels a thread: one 16-byte load of the residual, one 16-byte store
    // (hw and p0 are multiples of 8, so a unit is inside or past hw).
    constexpr int kU = kProjPx / 8;
    for (int u = threadIdx.x; u < cols_here * kU; u += kThreads) {
      const int col = u / kU, p = (u - col * kU) * 8;
      if (p0 + p >= hw) continue;
      const size_t o = (static_cast<size_t>(n) * c_out + n0 + col) * hw + p0 + p;
      const uint4 r = res != nullptr ? *reinterpret_cast<const uint4*>(res + o)
                                     : make_uint4(0u, 0u, 0u, 0u);
      const float4 ya = *reinterpret_cast<const float4*>(s_o + col * kOp + p);
      const float4 yb = *reinterpret_cast<const float4*>(s_o + col * kOp + p + 4);
      const float y[8] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
      const unsigned rw[4] = {r.x, r.y, r.z, r.w};
      unsigned w[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float y0 = y[2 * t], y1 = y[2 * t + 1];
        if (res != nullptr) {
          y0 = __fadd_rn(y0, bf16_lo(rw[t]));
          y1 = __fadd_rn(y1, bf16_hi(rw[t]));
        }
        const __nv_bfloat162 v = __floats2bfloat162_rn(y0, y1);
        w[t] = *reinterpret_cast<const unsigned*>(&v);
      }
      *reinterpret_cast<uint4*>(out + o) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    for (int i = threadIdx.x; i < cols_here * kProjPx; i += kThreads) {
      const int col = i / kProjPx, p = i - col * kProjPx;
      if (p0 + p >= hw) continue;
      const size_t o = (static_cast<size_t>(n) * c_out + n0 + col) * hw + p0 + p;
      float y = s_o[col * kOp + p];
      if (res != nullptr) y = __fadd_rn(y, __bfloat162float(res[o]));
      out[o] = __float2bfloat16_rn(y);
    }
  }
}

// Launches se_project_mma_kernel with kMaxNt = cols / 8.
template <int NT>
cudaError_t launch_project(int cols, dim3 grid, size_t smem, cudaStream_t stream,
                           const float* h2, int hw_pitch, const float* gate, const bf16* w3,
                           const float* b3, const bf16* res, bf16* out, int c_mid, int c_out,
                           int hw) {
  if (cols / 8 != NT) {
    if constexpr (NT > 2) {
      return launch_project<NT - 2>(cols, grid, smem, stream, h2, hw_pitch, gate, w3, b3, res,
                                    out, c_mid, c_out, hw);
    }
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = set_smem(se_project_mma_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  se_project_mma_kernel<NT><<<grid, kThreads, smem, stream>>>(h2, hw_pitch, gate, w3, b3, res,
                                                              out, c_mid, c_out, hw);
  return cudaGetLastError();
}

// geoms: per block c_in, c_mid, c_se, c_out, stride, residual, TH, TW, then
// P (f32: pixels per CTA of se_project_kernel) or CH and CG (bf16: expanded
// channels per chunk and per CTA of expand_dw_mma_kernel; 0 for f32).
// ptrs: stem_w, stem_b, then per block w1, b1, wd, bd, se1, bse1, se2,
// bse2, w3, b3. h2's planes are Ho * Wo floats apart (f32) or hw_pitch =
// Ho * Wo rounded up to 4 (bf16: 16-byte cp.async copies). gate [N, c_mid]
// is the bf16 path's scratch for the squeeze-excite gate (f32 recomputes it
// in every CTA of launch (b)). bf16: 1 + 3k launches (stem; per block
// expand + depthwise, gate, project).
template <typename T, bool kFast>
int run(int n_blocks, const int* geoms, const void* const* ptrs, const void* img,
        void* out, void* act0, void* act1, float* h2, float* part, float* gate, int N,
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
    const int* g = geoms + 10 * b;
    const int c_in = g[0], c_mid = g[1], c_se = g[2], c_out = g[3];
    const int stride = g[4], residual = g[5], TH = g[6], TW = g[7], last = g[8];
    const void* const* wp = ptrs + 2 + 10 * b;
    const int ho = (h - 1) / stride + 1, wo = (w - 1) / stride + 1;
    const int hw = ho * wo, hw_pitch = round_up(hw, 4);
    const int n_tiles = ((ho + TH - 1) / TH) * ((wo + TW - 1) / TW);
    T* dst = b == n_blocks - 1 ? static_cast<T*>(out)
                               : (cur == static_cast<T*>(act0) ? static_cast<T*>(act1)
                                                               : static_cast<T*>(act0));
    const T* res = residual ? cur : nullptr;
    cudaError_t err;
    if constexpr (std::is_same<T, float>::value) {
      const int P = last;
      const int IH = stride * (TH - 1) + 3, IW = stride * (TW - 1) + 3;
      const size_t pitch = static_cast<size_t>(IH * IW + kPx - 1) / kPx * kPx;
      const size_t smem_a = sizeof(float) * (static_cast<size_t>(c_in) * pitch +
                                             static_cast<size_t>(kChunk) * pitch +
                                             static_cast<size_t>(c_in) * kChunk);
      err = set_smem(expand_dw_kernel<T, kFast>, smem_a);
      if (err != cudaSuccess) return static_cast<int>(err);
      expand_dw_kernel<T, kFast><<<dim3(n_tiles, N), kThreads, smem_a, stream>>>(
          cur, static_cast<const T*>(wp[0]), static_cast<const float*>(wp[1]),
          static_cast<const float*>(wp[2]), static_cast<const float*>(wp[3]), h2, part,
          c_in, c_mid, h, w, ho, wo, stride, TH, TW);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      const int c_pad = (c_out + kCh - 1) / kCh * kCh;
      const size_t smem_b = sizeof(float) * (static_cast<size_t>(kChunk) * (P + c_pad) +
                                             2 * c_mid + c_se);
      err = set_smem(se_project_kernel<T>, smem_b);
      if (err != cudaSuccess) return static_cast<int>(err);
      se_project_kernel<T><<<dim3((hw + P - 1) / P, N), kThreads, smem_b, stream>>>(
          h2, part, n_tiles, static_cast<const float*>(wp[4]),
          static_cast<const float*>(wp[5]), static_cast<const float*>(wp[6]),
          static_cast<const float*>(wp[7]), static_cast<const T*>(wp[8]),
          static_cast<const float*>(wp[9]), res, dst, c_mid, c_se, c_out, hw, P);
    } else {
      const int CH = last, CG = g[9];
      if (CG <= 0 || CG % CH != 0) return static_cast<int>(cudaErrorInvalidValue);
      const ExpandSmem la = expand_smem(c_in, stride, TH, TW, CH, CG);
      const dim3 grid_a(n_tiles, (c_mid + CG - 1) / CG, N);
      if (CH == 16) {
        auto kernel = expand_dw_mma_kernel<2, kFast>;
        err = set_smem(kernel, la.total);
        if (err != cudaSuccess) return static_cast<int>(err);
        kernel<<<grid_a, kThreads, la.total, stream>>>(
            cur, static_cast<const T*>(wp[0]), static_cast<const float*>(wp[1]),
            static_cast<const float*>(wp[2]), static_cast<const float*>(wp[3]), h2, part, c_in,
            c_mid, h, w, ho, wo, hw_pitch, stride, TH, TW, CG);
      } else if (CH == 32) {
        auto kernel = expand_dw_mma_kernel<4, kFast>;
        err = set_smem(kernel, la.total);
        if (err != cudaSuccess) return static_cast<int>(err);
        kernel<<<grid_a, kThreads, la.total, stream>>>(
            cur, static_cast<const T*>(wp[0]), static_cast<const float*>(wp[1]),
            static_cast<const float*>(wp[2]), static_cast<const float*>(wp[3]), h2, part, c_in,
            c_mid, h, w, ho, wo, hw_pitch, stride, TH, TW, CG);
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      const int parts1 = c_se * ((c_mid + 31) / 32), parts2 = c_mid * ((c_se + 31) / 32);
      const int parts = parts1 > parts2 ? parts1 : parts2;
      const size_t smem_g = sizeof(float) * static_cast<size_t>(c_mid + c_se + parts);
      err = set_smem(se_gate_kernel, smem_g);
      if (err != cudaSuccess) return static_cast<int>(err);
      se_gate_kernel<<<N, kGateThreads, smem_g, stream>>>(
          part, n_tiles, static_cast<const float*>(wp[4]), static_cast<const float*>(wp[5]),
          static_cast<const float*>(wp[6]), static_cast<const float*>(wp[7]), gate, c_mid,
          c_se, hw);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      const int cols = round_up(c_out, 16) < kProjCols ? round_up(c_out, 16) : kProjCols;
      const ProjectSmem lb = project_smem(c_mid, cols);
      const dim3 grid_b((hw + kProjPx - 1) / kProjPx, (c_out + kProjCols - 1) / kProjCols, N);
      err = launch_project<kProjCols / 8>(cols, grid_b, lb.total, stream, h2, hw_pitch, gate,
                                          static_cast<const T*>(wp[8]),
                                          static_cast<const float*>(wp[9]), res, dst, c_mid,
                                          c_out, hw);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
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
                                      void* act1, void* h2, void* part, void* gate, int N,
                                      int C_stem, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* h = static_cast<float*>(h2);
  float* pt = static_cast<float*>(part);
  float* g = static_cast<float*>(gate);
  if (dtype == 0) {
    return fast_act ? run<float, true>(n_blocks, geoms, ptrs, img, out, act0, act1, h, pt, g,
                                       N, C_stem, H, W, s)
                    : run<float, false>(n_blocks, geoms, ptrs, img, out, act0, act1, h,
                                        pt, g, N, C_stem, H, W, s);
  }
  return fast_act ? run<__nv_bfloat16, true>(n_blocks, geoms, ptrs, img, out, act0, act1,
                                             h, pt, g, N, C_stem, H, W, s)
                  : run<__nv_bfloat16, false>(n_blocks, geoms, ptrs, img, out, act0,
                                              act1, h, pt, g, N, C_stem, H, W, s);
}
