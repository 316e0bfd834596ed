// Audio-frontend kernels for Hopper (sm_90a): the conv-form filterbank
// log-power (B2), the STFT -> power -> mel -> log spectrogram (B1), and the
// conv-form frontend over overlapping windows of one 1-D buffer (B5).
//
// Replaces the Pallas TPU kernels in birdnet_tpu/ops/pallas/frontend.py:
//   - filterbank_logpower_kernel replaces segments_filterbank_logpower
//     (_kernel_prefolded -> _filterbank_body, _assemble_patch);
//   - stft_melspec_kernel replaces segments_stft_melspec
//     (_kernel_stft_prefolded);
//   - frame_filterbank_logpower_kernel replaces frame_filterbank_logpower
//     (_kernel_row_aligned, _kernel_flat): B2's body over n windows at
//     offset i * step of one float32 or int16 buffer, the samples scaled in
//     the kernel, the product in f32 (the TPU kernel's HIGHEST dot), the
//     output f32 [n, T, F]. Any hop and step: the TPU's hop % 128 rule is a
//     Mosaic layout rule.
// Each computes what its TPU kernel computes, with the same rounding points:
// the framed samples arrive in the compute type T (f32 or bf16), every
// product accumulates in f32, B1's power is rounded to T before the mel
// projection, and the log is taken in f32 and rounded to T on store. Both
// write the [N, F|M, T] mel-image orientation directly.
//
// What bounds them on this card. B1 does about 0.66 GFLOP per segment
// (2 x 511 frames x 1024 taps x 316 DFT bins x 2) against about 290 KB of
// audio in: it is compute-bound. B2 does about 0.10 GFLOP per segment
// (511 x 1024 x 96 x 2) against the same input. This first version runs
// SIMT f32 FMAs: one block per (segment, tile of frames) stages the tile's
// overlapping samples in shared memory once, each thread keeps a register
// block of (2 bins or filters) x (8 or 16 frames) accumulators so one shared
// load feeds several FMAs, and the DFT bases and the filterbank are read from
// global memory, where they stay resident in L2. Tensor cores (wgmma) fed by
// TMA are later work.
//
// Plain C entry points, loaded with ctypes: each launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError() after the launch.

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
template <>
__device__ __forceinline__ float to_f32<short>(short v) {
  return static_cast<float>(v);
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

// Frames per block, frames per thread, and filters/bins per thread.
constexpr int kTileFrames = 32;
constexpr int kFbFramesPerThread = 8;
constexpr int kStftFramesPerThread = 16;
constexpr int kColsPerThread = 2;

__host__ __device__ __forceinline__ int tile_span(int hop, int flen) {
  return (kTileFrames - 1) * hop + flen;
}

// Stage samples [start, start + span) of one segment in shared memory as
// f32, zero past the segment's end (frames past n_frames read the zeros
// and are never stored).
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, float* s_x,
                                          int start, int span, int S) {
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int g = start + i;
    s_x[i] = g < S ? to_f32<T>(x[g]) : 0.0f;
  }
}

// B2: out[n, f, t] = log(y^2 + eps), y = sum_k x[n, t*hop + k] * w[f, k].
// wt is the filterbank transposed to [K, F] so that neighbouring threads
// (neighbouring filters) read neighbouring addresses.
template <typename T>
__global__ void filterbank_logpower_kernel(const T* __restrict__ seg,
                                           const T* __restrict__ wt,
                                           T* __restrict__ out, int S, int K,
                                           int hop, int F, int n_frames,
                                           float eps) {
  extern __shared__ float s_x[];
  const int n = blockIdx.y;
  const int t0 = blockIdx.x * kTileFrames;
  load_tile(seg + static_cast<size_t>(n) * S, s_x, t0 * hop,
            tile_span(hop, K), S);
  __syncthreads();

  constexpr int kGroups = kTileFrames / kFbFramesPerThread;
  const int half = (F + kColsPerThread - 1) / kColsPerThread;
  for (int item = threadIdx.x; item < half * kGroups; item += blockDim.x) {
    const int f0 = item % half;
    const int f1 = f0 + half;
    const int j0 = (item / half) * kFbFramesPerThread;
    const bool has1 = f1 < F;
    float acc0[kFbFramesPerThread] = {};
    float acc1[kFbFramesPerThread] = {};
    const float* xs = s_x + j0 * hop;
    for (int k = 0; k < K; ++k) {
      const float w0 = to_f32<T>(wt[static_cast<size_t>(k) * F + f0]);
      const float w1 = has1 ? to_f32<T>(wt[static_cast<size_t>(k) * F + f1]) : 0.0f;
#pragma unroll
      for (int j = 0; j < kFbFramesPerThread; ++j) {
        const float v = xs[j * hop + k];
        acc0[j] = fmaf(v, w0, acc0[j]);
        acc1[j] = fmaf(v, w1, acc1[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kFbFramesPerThread; ++j) {
      const int t = t0 + j0 + j;
      if (t >= n_frames) break;
      // y*y and +eps rounded separately, as the reference does (no FMA).
      out[(static_cast<size_t>(n) * F + f0) * n_frames + t] =
          from_f32<T>(logf(__fadd_rn(__fmul_rn(acc0[j], acc0[j]), eps)));
      if (has1) {
        out[(static_cast<size_t>(n) * F + f1) * n_frames + t] =
            from_f32<T>(logf(__fadd_rn(__fmul_rn(acc1[j], acc1[j]), eps)));
      }
    }
  }
}

// B1: power[t, b] = c^2 + s^2 over the mel bank's nonzero bins, with
// c = x_t . bc[:, b] and s = x_t . bs[:, b] (the window folded into the
// bases), then out[n, m, t] = log(sum_b power[t, b] * mel[b, m] + eps).
// bc and bs are [flen, bins], mel is [bins, M]. The power tile stays in
// shared memory between the two products.
template <typename T>
__global__ void stft_melspec_kernel(const T* __restrict__ seg,
                                    const T* __restrict__ bc,
                                    const T* __restrict__ bs,
                                    const T* __restrict__ mel,
                                    T* __restrict__ out, int S, int flen,
                                    int hop, int bins, int M, int n_frames,
                                    float eps) {
  extern __shared__ float smem[];
  const int span = tile_span(hop, flen);
  float* s_x = smem;
  float* s_p = smem + span;  // [kTileFrames, bins]
  const int n = blockIdx.y;
  const int t0 = blockIdx.x * kTileFrames;
  load_tile(seg + static_cast<size_t>(n) * S, s_x, t0 * hop, span, S);
  __syncthreads();

  constexpr int kGroups = kTileFrames / kStftFramesPerThread;
  const int half = (bins + kColsPerThread - 1) / kColsPerThread;
  for (int item = threadIdx.x; item < half * kGroups; item += blockDim.x) {
    const int b0 = item % half;
    const int b1 = b0 + half;
    const int j0 = (item / half) * kStftFramesPerThread;
    const bool has1 = b1 < bins;
    float c0[kStftFramesPerThread] = {};
    float s0[kStftFramesPerThread] = {};
    float c1[kStftFramesPerThread] = {};
    float s1[kStftFramesPerThread] = {};
    const float* xs = s_x + j0 * hop;
    for (int k = 0; k < flen; ++k) {
      const size_t row = static_cast<size_t>(k) * bins;
      const float cb0 = to_f32<T>(bc[row + b0]);
      const float sb0 = to_f32<T>(bs[row + b0]);
      const float cb1 = has1 ? to_f32<T>(bc[row + b1]) : 0.0f;
      const float sb1 = has1 ? to_f32<T>(bs[row + b1]) : 0.0f;
#pragma unroll
      for (int j = 0; j < kStftFramesPerThread; ++j) {
        const float v = xs[j * hop + k];
        c0[j] = fmaf(v, cb0, c0[j]);
        s0[j] = fmaf(v, sb0, s0[j]);
        c1[j] = fmaf(v, cb1, c1[j]);
        s1[j] = fmaf(v, sb1, s1[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kStftFramesPerThread; ++j) {
      // c*c + s*s in f32, then rounded to T: the mel product's operand.
      const float p0 = __fadd_rn(__fmul_rn(c0[j], c0[j]), __fmul_rn(s0[j], s0[j]));
      s_p[(j0 + j) * bins + b0] = to_f32<T>(from_f32<T>(p0));
      if (has1) {
        const float p1 = __fadd_rn(__fmul_rn(c1[j], c1[j]), __fmul_rn(s1[j], s1[j]));
        s_p[(j0 + j) * bins + b1] = to_f32<T>(from_f32<T>(p1));
      }
    }
  }
  __syncthreads();

  const int frames = min(kTileFrames, n_frames - t0);
  for (int item = threadIdx.x; item < M * frames; item += blockDim.x) {
    const int m = item % M;
    const int j = item / M;
    const float* p = s_p + j * bins;
    float acc = 0.0f;
    for (int b = 0; b < bins; ++b) {
      acc = fmaf(p[b], to_f32<T>(mel[static_cast<size_t>(b) * M + m]), acc);
    }
    out[(static_cast<size_t>(n) * M + m) * n_frames + t0 + j] =
        from_f32<T>(logf(__fadd_rn(acc, eps)));
  }
}

// B5: out[n, t, f] = log(y^2 + eps), y = sum_k (scale * audio[n * step +
// t * hop + k]) * w[f, k], all in f32. The B2 body over one buffer: the
// window's samples come straight from global memory at offset n * step.
template <typename A>
__global__ void frame_filterbank_logpower_kernel(
    const A* __restrict__ audio, const float* __restrict__ wt,
    float* __restrict__ out, long long audio_len, int step, int K, int hop,
    int F, int n_frames, float eps, float scale) {
  extern __shared__ float s_x[];
  const int n = blockIdx.y;
  const int t0 = blockIdx.x * kTileFrames;
  const long long start = static_cast<long long>(n) * step + static_cast<long long>(t0) * hop;
  const int span = tile_span(hop, K);
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const long long g = start + i;
    s_x[i] = g < audio_len ? __fmul_rn(to_f32<A>(audio[g]), scale) : 0.0f;
  }
  __syncthreads();

  constexpr int kGroups = kTileFrames / kFbFramesPerThread;
  const int half = (F + kColsPerThread - 1) / kColsPerThread;
  for (int item = threadIdx.x; item < half * kGroups; item += blockDim.x) {
    const int f0 = item % half;
    const int f1 = f0 + half;
    const int j0 = (item / half) * kFbFramesPerThread;
    const bool has1 = f1 < F;
    float acc0[kFbFramesPerThread] = {};
    float acc1[kFbFramesPerThread] = {};
    const float* xs = s_x + j0 * hop;
    for (int k = 0; k < K; ++k) {
      const float w0 = wt[static_cast<size_t>(k) * F + f0];
      const float w1 = has1 ? wt[static_cast<size_t>(k) * F + f1] : 0.0f;
#pragma unroll
      for (int j = 0; j < kFbFramesPerThread; ++j) {
        const float v = xs[j * hop + k];
        acc0[j] = fmaf(v, w0, acc0[j]);
        acc1[j] = fmaf(v, w1, acc1[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kFbFramesPerThread; ++j) {
      const int t = t0 + j0 + j;
      if (t >= n_frames) break;
      float* row = out + (static_cast<size_t>(n) * n_frames + t) * F;
      row[f0] = logf(__fadd_rn(__fmul_rn(acc0[j], acc0[j]), eps));
      if (has1) row[f1] = logf(__fadd_rn(__fmul_rn(acc1[j], acc1[j]), eps));
    }
  }
}

int round_up_threads(int items) {
  const int t = (items + 31) / 32 * 32;
  return t < 1024 ? t : 1024;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch_filterbank(const void* seg, const void* wt, void* out, int N, int S,
                      int K, int hop, int F, int n_frames, float eps,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * tile_span(hop, K);
  cudaError_t err = set_smem(filterbank_logpower_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + kTileFrames - 1) / kTileFrames, N);
  const int half = (F + kColsPerThread - 1) / kColsPerThread;
  const int threads =
      round_up_threads(half * (kTileFrames / kFbFramesPerThread));
  filterbank_logpower_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(seg), static_cast<const T*>(wt),
      static_cast<T*>(out), S, K, hop, F, n_frames, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stft(const void* seg, const void* bc, const void* bs,
                const void* mel, void* out, int N, int S, int flen, int hop,
                int bins, int M, int n_frames, float eps, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (tile_span(hop, flen) + static_cast<size_t>(kTileFrames) * bins);
  cudaError_t err = set_smem(stft_melspec_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + kTileFrames - 1) / kTileFrames, N);
  const int half = (bins + kColsPerThread - 1) / kColsPerThread;
  const int threads =
      round_up_threads(half * (kTileFrames / kStftFramesPerThread));
  stft_melspec_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(seg), static_cast<const T*>(bc),
      static_cast<const T*>(bs), static_cast<const T*>(mel),
      static_cast<T*>(out), S, flen, hop, bins, M, n_frames, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename A>
int launch_frame_filterbank(const void* audio, const void* wt, void* out, int N,
                            long long audio_len, int step, int K, int hop, int F,
                            int n_frames, float eps, float scale,
                            cudaStream_t stream) {
  const size_t smem = sizeof(float) * tile_span(hop, K);
  cudaError_t err = set_smem(frame_filterbank_logpower_kernel<A>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + kTileFrames - 1) / kTileFrames, N);
  const int half = (F + kColsPerThread - 1) / kColsPerThread;
  const int threads =
      round_up_threads(half * (kTileFrames / kFbFramesPerThread));
  frame_filterbank_logpower_kernel<A><<<grid, threads, smem, stream>>>(
      static_cast<const A*>(audio), static_cast<const float*>(wt),
      static_cast<float*>(out), audio_len, step, K, hop, F, n_frames, eps, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (segments, weights and output alike).
extern "C" int bn_filterbank_logpower(int dtype, const void* seg,
                                      const void* wt, void* out, int N, int S,
                                      int K, int hop, int F, int n_frames,
                                      float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_filterbank<float>(seg, wt, out, N, S, K, hop, F, n_frames,
                                    eps, s);
  }
  return launch_filterbank<__nv_bfloat16>(seg, wt, out, N, S, K, hop, F,
                                          n_frames, eps, s);
}

extern "C" int bn_stft_melspec(int dtype, const void* seg, const void* bc,
                               const void* bs, const void* mel, void* out,
                               int N, int S, int flen, int hop, int bins,
                               int M, int n_frames, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_stft<float>(seg, bc, bs, mel, out, N, S, flen, hop, bins, M,
                              n_frames, eps, s);
  }
  return launch_stft<__nv_bfloat16>(seg, bc, bs, mel, out, N, S, flen, hop,
                                    bins, M, n_frames, eps, s);
}

// in_dtype: 0 = float32, 1 = int16 audio; weights and output are float32.
extern "C" int bn_frame_filterbank_logpower(int in_dtype, const void* audio,
                                            const void* wt, void* out, int N,
                                            long long audio_len, int step, int K,
                                            int hop, int F, int n_frames,
                                            float eps, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0) {
    return launch_frame_filterbank<float>(audio, wt, out, N, audio_len, step, K, hop,
                                          F, n_frames, eps, scale, s);
  }
  return launch_frame_filterbank<short>(audio, wt, out, N, audio_len, step, K, hop, F,
                                        n_frames, eps, scale, s);
}
