// Audio-frontend kernels for Hopper (sm_90a): the conv-form filterbank
// log-power (B2), the STFT -> power -> mel -> log spectrogram (B1), and the
// conv-form frontend over overlapping windows of one 1-D buffer (B5).
//
// Replaces the Pallas TPU kernels in birdnet_tpu/ops/pallas/frontend.py:
//   - filterbank_logpower_mma_kernel (bf16) and filterbank_logpower_kernel
//     (f32) replace segments_filterbank_logpower (_kernel_prefolded ->
//     _filterbank_body, _assemble_patch);
//   - stft_melspec_mma_kernel (bf16) and stft_melspec_kernel (f32) replace
//     segments_stft_melspec (_kernel_stft_prefolded);
//   - frame_filterbank_tf32_kernel replaces frame_filterbank_logpower
//     (_kernel_row_aligned, _kernel_flat): the conv-form frontend over n
//     windows at offset i * step of one float32 or int16 buffer, the
//     samples scaled in the kernel, the product f32-accurate (the TPU
//     kernel's HIGHEST dot, a multi-pass product there; split TF32 here),
//     the output f32 [n, T, F]. Any step; hops up to
//     bn_frame_filterbank_max_hop (the TPU's hop % 128 rule is a Mosaic
//     layout rule).
// Each computes what its TPU kernel computes, with the same rounding points:
// the framed samples arrive in the compute type (f32 or bf16; B1 and B2
// multiply them by their scale in f32 and round back to it, in shared memory
// after staging, where scale != 1, as the TPU kernels' seg * f32(scale)
// before the compute-type cast), every product
// accumulates in f32, B1's power c*c + s*s is rounded to the compute type
// before the mel projection, B2's y*y + eps rounds the multiply and the add
// separately, and the log is taken in f32 and rounded on store. B1 and B2
// write the [N, F|M, T] mel-image orientation directly.
//
// What bounds them on this card (H100 SXM: 989 TFLOP/s bf16 dense,
// 3.35 TB/s). At v2.4's geometry (511 frames of 1024 taps at hop 280, 316
// DFT bins, 96 mels or filters) B1 does 0.69 GFLOP per segment (the DFT
// 2 x 511 x 1024 x 316 x 2, the mel product 511 x 316 x 96 x 2) against
// about 0.4 MB moved: compute-bound at 0.70 us per segment. B2 does 0.10
// GFLOP per segment (0.10 us) against 288 KB of bf16 audio in and 98 KB out
// (0.115 us): memory-bound. A library GEMM on materialised frames reads 3.66x
// the audio, since 1024-tap frames at hop 280 overlap.
//
// The bf16 kernels (the fast/bf16 main path) run on the tensor cores with
// wgmma.mma_async m64nNk16 (bf16 operands, f32 accumulators, A from
// registers, B from shared memory):
//   - one CTA of two warpgroups per (segment, tile of 128 frames, column
//     group) stages the tile's sample span once in shared memory with
//     cp.async, as bf16; frames are never materialised in device memory
//     (one warpgroup, 64 frames, where a hop above about 600 samples makes
//     the span of 128 frames too large; above about 1200 even 64 frames do
//     not fit, and the launch is refused);
//   - each warp owns 16 frames; its A fragments come straight from the span
//     (frame r, tap k at span[r * hop + k]): one ldmatrix.x4 per k16 step
//     when every row start is 16-byte aligned (hop 280, 312 and 320 on
//     aligned segments; conflict free at 280 and 312, while at 320 the 8
//     rows of a matrix share a bank), two 16-bit loads per pair of taps
//     otherwise (any other hop, segment length or offset);
//   - the B operand (B2's filterbank, B1's cos|sin bases), packed on the
//     host into 64-tap chunks of wgmma's unswizzled K-major core matrices,
//     streams through a 4-stage ring of bulk copies (the TMA, one thread
//     issuing, an mbarrier per stage) shared by both warpgroups: each chunk
//     read from L2 serves 128 frames;
//   - the MMAs of one chunk run while the next chunk's A fragments load
//     (two register buffers, one wgmma group in flight);
//   - B1 loops over chunks of 64 DFT bins: c and s accumulate over all taps,
//     then bf16(c*c + s*s) is built in registers straight into the mel
//     product's A fragments (an m64n16 accumulator pair is an m64k16 A
//     fragment), and the mel product runs on the tensor cores against the
//     chunk's mel rows, accumulating in f32 across chunks;
//   - the epilogue goes through shared memory so that the [F, T] store is
//     coalesced along T.
// The sums run in another order than the plain version's matmul; the
// bf16 results agree with it within 2^-6 |plain| + 1e-2 (a flipped bf16
// rounding of the power or of the output).
// B5 runs on the tensor cores in split TF32 ("3xTF32"): each operand x is
// big + small with big = tf32(x) and small = tf32(x - big) (cvt.rna), and
// the product sums big*big + big*small + small*big in f32. int16 samples
// scaled by 2^-15 have 16 significant bits, so big + small is exact and
// only the weights' small*small term is dropped (about 2^-22 relative).
// It bounds B5 at 3 x 2 n T K F operations at 495 TFLOP/s (0.61 us per
// segment at v2.4's geometry) against 0.15 us of bytes. The kernel follows
// B2's: one CTA of up to two warpgroups per (window, frame tile, column
// group) stages the tile's span once with cp.async, kept in the input's
// type (int16 halves it) and scaled and split into TF32 A fragments as
// they load; the B operand (w_big | w_small, packed on the host into 32-tap
// chunks of core matrices, 24 KB per chunk at 96 filters) streams through
// the 4-stage TMA ring; wgmma.m64nNk8.tf32 with A from registers; the
// output goes straight from the accumulators to [n, T, F], two adjacent
// filters per thread. Where a large hop's span of 64 frames would not fit,
// a warpgroup covers 32 or 16 frames (its other rows are zero).
// The f32 kernels of B1 and B2 keep SIMT f32 FMAs: their contract is the TPU's
// Precision.HIGHEST, exact f32 products with no TF32. One block per
// (segment, tile of 32 frames) stages the tile's samples in shared memory
// once; each thread keeps a register block of (2 bins or filters) x (8 or
// 16 frames) accumulators; the bases and the filterbank are read from
// global memory, where they stay resident in L2.
//
// Plain C entry points, loaded with ctypes: each launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32 SIMT kernels
// ---------------------------------------------------------------------------

// Frames per block, frames per thread, and filters/bins per thread.
constexpr int kTileFrames = 32;
constexpr int kFbFramesPerThread = 8;
constexpr int kStftFramesPerThread = 16;
constexpr int kColsPerThread = 2;

__host__ __device__ __forceinline__ int tile_span(int hop, int flen) {
  return (kTileFrames - 1) * hop + flen;
}

// Stage samples [start, start + span) of one segment in shared memory,
// times scale (exact at 1), zero past the segment's end (frames past
// n_frames read the zeros and are never stored).
__device__ __forceinline__ void load_tile(const float* __restrict__ x, float* s_x,
                                          int start, int span, int S, float scale) {
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int g = start + i;
    s_x[i] = g < S ? __fmul_rn(x[g], scale) : 0.0f;
  }
}

// B2: out[n, f, t] = log(y^2 + eps), y = sum_k scale * x[n, t*hop + k] *
// w[f, k].
// wt is the filterbank transposed to [K, F] so that neighbouring threads
// (neighbouring filters) read neighbouring addresses.
__global__ void filterbank_logpower_kernel(const float* __restrict__ seg,
                                           const float* __restrict__ wt,
                                           float* __restrict__ out, int S, int K,
                                           int hop, int F, int n_frames,
                                           float eps, float scale) {
  extern __shared__ float s_x[];
  const int n = blockIdx.y;
  const int t0 = blockIdx.x * kTileFrames;
  load_tile(seg + static_cast<size_t>(n) * S, s_x, t0 * hop,
            tile_span(hop, K), S, scale);
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
      // y*y and +eps rounded separately, as the reference does (no FMA).
      out[(static_cast<size_t>(n) * F + f0) * n_frames + t] =
          logf(__fadd_rn(__fmul_rn(acc0[j], acc0[j]), eps));
      if (has1) {
        out[(static_cast<size_t>(n) * F + f1) * n_frames + t] =
            logf(__fadd_rn(__fmul_rn(acc1[j], acc1[j]), eps));
      }
    }
  }
}

// B1: power[t, b] = c^2 + s^2 over the mel bank's nonzero bins, with
// c = x_t . bc[:, b] and s = x_t . bs[:, b] (the window folded into the
// bases), then out[n, m, t] = log(sum_b power[t, b] * mel[b, m] + eps).
// bc and bs are [flen, bins], mel is [bins, M]. The power tile stays in
// shared memory between the two products.
__global__ void stft_melspec_kernel(const float* __restrict__ seg,
                                    const float* __restrict__ bc,
                                    const float* __restrict__ bs,
                                    const float* __restrict__ mel,
                                    float* __restrict__ out, int S, int flen,
                                    int hop, int bins, int M, int n_frames,
                                    float eps, float scale) {
  extern __shared__ float smem[];
  const int span = tile_span(hop, flen);
  float* s_x = smem;
  float* s_p = smem + span;  // [kTileFrames, bins]
  const int n = blockIdx.y;
  const int t0 = blockIdx.x * kTileFrames;
  load_tile(seg + static_cast<size_t>(n) * S, s_x, t0 * hop, span, S, scale);
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
      const float cb0 = bc[row + b0];
      const float sb0 = bs[row + b0];
      const float cb1 = has1 ? bc[row + b1] : 0.0f;
      const float sb1 = has1 ? bs[row + b1] : 0.0f;
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
      // c*c + s*s in f32: the mel product's operand.
      s_p[(j0 + j) * bins + b0] =
          __fadd_rn(__fmul_rn(c0[j], c0[j]), __fmul_rn(s0[j], s0[j]));
      if (has1) {
        s_p[(j0 + j) * bins + b1] =
            __fadd_rn(__fmul_rn(c1[j], c1[j]), __fmul_rn(s1[j], s1[j]));
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
      acc = fmaf(p[b], mel[static_cast<size_t>(b) * M + m], acc);
    }
    out[(static_cast<size_t>(n) * M + m) * n_frames + t0 + j] =
        logf(__fadd_rn(acc, eps));
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// The host packs the B operands for this tiling (ops/cuda/frontend.py,
// MMA_TAPS, MMA_BINS, MMA_MAX_COLS).
constexpr int kMmaKc = 64;             // taps per chunk of the B ring
constexpr int kStages = 4;              // B ring depth
constexpr int kLookahead = kStages - 2; // chunks in flight ahead of the one the MMAs read
constexpr int kStftCols = 128;          // B1 columns per chunk: cos 64 | sin 64
constexpr int kMaxWarpgroups = 2;       // per CTA, sharing each B chunk; 64 frames each
// A B chunk in shared memory is [cols / 8][kMmaKc / 8] core matrices of 8
// columns x 8 taps (128 contiguous bytes): wgmma's K-major layout without
// swizzle. Neighbours along K are 128 bytes apart, along N 1024.
constexpr unsigned kCoreBytes = 128;
constexpr unsigned kCoreRowBytes = kCoreBytes * (kMmaKc / 8);

// The B ring of ring_cols-column chunks, which then holds the output tile
// of out_cols columns and tile_rows frames: its size in elements (a
// multiple of 8, so that what follows stays 16-byte aligned).
__host__ __device__ __forceinline__ int ring_elems(int ring_cols, int out_cols, int tile_rows) {
  const int ring = kStages * ring_cols * kMmaKc;
  const int tile = out_cols * (tile_rows + 8);
  return ring > tile ? ring : tile;
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The descriptor of a B chunk starting at p (core matrices of 8 columns x
// 16 bytes: 8 bf16 or 4 f32 taps): 128 bytes apart along K, kCoreRowBytes
// along N.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return smem_desc_kmajor(p, kCoreBytes, kCoreRowBytes);
}

// d[NT][4] += a (this warp's 16 of the warpgroup's 64 rows, 16 taps, in
// registers) x B (16 taps x NT * 8 columns at desc), asynchronously: the
// m64nNk16 bf16 wgmma with f32 accumulators. d[j] holds columns 8j..8j+7 in
// mma.sync's accumulator layout.
template <int NT>
struct Wgmma;

template <>
struct Wgmma<4> {
  static __device__ __forceinline__ void run(float (&d)[4][4], const unsigned (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void run(float (&d)[8][4], const unsigned (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<12> {
  static __device__ __forceinline__ void run(float (&d)[12][4], const unsigned (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void run(float (&d)[16][4], const unsigned (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// Stage elements [a0, a0 + len) of the flat input (bf16, int16 or f32) in
// s, counting elements from the 16-byte-aligned address base: whole 16-byte
// pieces from a0 rounded down to a piece, zero at and past hi (the
// segment's or the buffer's end), so frames past it read zeros and are
// never stored. Returns a0's offset in s. Issues cp.async without
// committing.
template <typename T>
__device__ __forceinline__ int stage_span(const T* base, long long a0, int len, long long hi,
                                          T* s) {
  constexpr int kPer = 16 / sizeof(T);
  const long long a_al = a0 & ~static_cast<long long>(kPer - 1);
  const int pieces = static_cast<int>((a0 - a_al + len + kPer - 1) / kPer);
  for (int p = threadIdx.x; p < pieces; p += blockDim.x) {
    const long long g = a_al + static_cast<long long>(kPer) * p;
    const long long valid = hi - g;
    const int bytes = valid >= kPer ? 16
                                    : (valid > 0 ? static_cast<int>(valid * sizeof(T)) : 0);
    cp_async16(s + kPer * p, bytes > 0 ? base + g : base, bytes);
  }
  return static_cast<int>(a0 - a_al);
}

// Once the span has landed: every staged sample times scale, in f32, rounded
// back to bf16, as the plain version scales the segments before framing
// (the JAX kernels' seg * f32(scale) before the compute-type cast). Waits
// for this thread's copies and for every thread's; the caller syncs again
// before reading the span.
__device__ __forceinline__ void scale_span(bf16* s, int staged, float scale) {
  cp_async_wait_all();
  __syncthreads();
  for (int i = threadIdx.x; i < staged; i += blockDim.x) {
    s[i] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(s[i]), scale));
  }
}

__device__ __forceinline__ unsigned pair16(const unsigned short* h, int i) {
  return static_cast<unsigned>(h[i]) | (static_cast<unsigned>(h[i + 1]) << 16);
}

// How a thread loads its A fragments from the staged span (frame r, tap k
// at span[r * hop + k]):
//   kMatrix: every row start is 16-byte aligned (hop, segment length and
//     the input's address are multiples of 8 elements): one ldmatrix.x4
//     per k16 step, lane l giving row (l & 7) + 8 ((l >> 3) & 1), taps
//     8 (l >> 4) onwards; at hop 280 and 312 the 8 rows of a matrix fall
//     on distinct banks;
//   kHalves: otherwise: two 16-bit loads per pair of taps, right at any
//     offset.
enum ALoad { kHalves, kMatrix };

// This thread's A fragment of one m16k16 step: ra and rb (= ra + 8 hop) are
// the span offsets of its two frames' tap 2t, rm its ldmatrix row's, and k0
// the step's first tap.
template <int kLoad>
__device__ __forceinline__ void load_a(const bf16* s, int ra, int rb, int rm, int k0,
                                       unsigned (&a)[4]) {
  if (kLoad == kMatrix) {
    ldmatrix_x4(a, s + rm + k0);
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(s);
    a[0] = pair16(h, ra + k0);
    a[1] = pair16(h, rb + k0);
    a[2] = pair16(h, ra + k0 + 8);
    a[3] = pair16(h, rb + k0 + 8);
  }
}

// The same with the taps at or past K zero (tap = k0 + 2t is this thread's
// first tap).
__device__ __forceinline__ unsigned pair16_masked(const unsigned short* h, int i, int tap,
                                                  int K) {
  const unsigned lo = tap < K ? h[i] : 0u;
  const unsigned hi = tap + 1 < K ? h[i + 1] : 0u;
  return lo | (hi << 16);
}

__device__ __forceinline__ void load_a_masked(const bf16* s, int ra, int rb, int k0,
                                              int tap, int K, unsigned (&a)[4]) {
  const unsigned short* h = reinterpret_cast<const unsigned short*>(s);
  a[0] = pair16_masked(h, ra + k0, tap, K);
  a[1] = pair16_masked(h, rb + k0, tap, K);
  a[2] = pair16_masked(h, ra + k0 + 8, tap + 8, K);
  a[3] = pair16_masked(h, rb + k0 + 8, tap + 8, K);
}

constexpr int kSteps = kMmaKc / 16;  // k16 steps per chunk

// This thread's A fragments of one chunk (the taps of the chunk's four
// k16 steps). The chunk that holds tap K - 1 when K % 64 != 0 zeroes the
// taps at or past K (the packed B is zero there too; the span covers the
// whole chunk).
template <int kLoad>
__device__ __forceinline__ void load_chunk_a(unsigned (&a)[kSteps][4], const bf16* s_x,
                                             int ra, int rb, int rm, int chunk, int kchunks,
                                             int K, int tq) {
  const int kbase = chunk * kMmaKc;
  if (chunk == kchunks - 1 && K % kMmaKc != 0) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      load_a_masked(s_x, ra, rb, kbase + kk * 16, kbase + kk * 16 + tq, K, a[kk]);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) load_a<kLoad>(s_x, ra, rb, rm, kbase + kk * 16, a[kk]);
  }
}

// acc += frames (the warpgroup's 64 rows, one chunk of taps, in a) x the
// staged chunk (NT * 8 columns): four wgmma, committed as one group and
// left in flight.
template <int NT>
__device__ __forceinline__ void issue_chunk(float (&acc)[NT][4], const unsigned (&a)[kSteps][4],
                                           const bf16* stage) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    Wgmma<NT>::run(acc, a[kk], smem_desc(stage + kk * 2 * (kCoreBytes / 2)));
  }
  wgmma_commit();
}

// Write acc (this warp's 16 rows x NT * 8 columns) through fn into the
// [cols, pitch] shared tile s_o, transposed: s_o[col][row].
template <int NT, typename Fn>
__device__ __forceinline__ void stage_out(const float (&acc)[NT][4], bf16* s_o, int pitch,
                                          int row, int tq, Fn fn) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 8 + tq;
    s_o[col * pitch + row] = __float2bfloat16_rn(fn(acc[j][0]));
    s_o[(col + 1) * pitch + row] = __float2bfloat16_rn(fn(acc[j][1]));
    s_o[col * pitch + row + 8] = __float2bfloat16_rn(fn(acc[j][2]));
    s_o[(col + 1) * pitch + row + 8] = __float2bfloat16_rn(fn(acc[j][3]));
  }
}

// Store the [cols, tm] tile s_o as out[n, col_base + col, t0 + r] for the
// columns below n_cols and the frames below n_frames: a warp per column,
// its lanes along T, so that the store is coalesced.
__device__ __forceinline__ void store_out(const bf16* s_o, int pitch, int cols, int tm,
                                          bf16* out, int n, int n_cols, int col_base,
                                          int n_frames, int t0) {
  const int frames = min(tm, n_frames - t0);
  const int warps = blockDim.x >> 5;
  const int cols_here = min(cols, n_cols - col_base);
  for (int col = threadIdx.x >> 5; col < cols_here; col += warps) {
    bf16* row = out + (static_cast<size_t>(n) * n_cols + col_base + col) * n_frames + t0;
    for (int r = threadIdx.x & 31; r < frames; r += 32) row[r] = s_o[col * pitch + r];
  }
}

// B2 in bf16: out[n, f, t] = bf16(log(y*y + eps)), y = sum_k x[n, t*hop + k]
// * w[f, k] in f32. Grid (frame tiles, N, column groups); blockDim 32 x
// warps, 16 frames per warp. wpack is [groups, kchunks, NT*8, kMmaKc].
template <int NT, int kLoad>
__global__ void __launch_bounds__(128 * kMaxWarpgroups)
    filterbank_logpower_mma_kernel(const bf16* __restrict__ base, int lead0,
                                   const bf16* __restrict__ wpack, bf16* __restrict__ out,
                                   int S, int K, int hop, int F, int n_frames, int kchunks,
                                   int span_len, int span_alloc, float eps, float scale) {
  constexpr int kCols = NT * 8;
  constexpr unsigned kChunkBytes = sizeof(bf16) * kCols * kMmaKc;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int tm = blockDim.x / 2;  // 64 frames per warpgroup of 128 threads
  bf16* s_x = reinterpret_cast<bf16*>(mma_smem);
  bf16* ring = s_x + span_alloc;  // [kStages][kCols * kMmaKc]; then the output tile
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ring_elems(kCols, kCols, tm));
  const int n = blockIdx.y;
  const int t0 = blockIdx.x * tm;
  const bf16* wg = wpack + static_cast<size_t>(blockIdx.z) * kchunks * kCols * kMmaKc;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st]);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < kLookahead && i < kchunks; ++i) {
      bulk_load(ring + i * kCols * kMmaKc, wg + static_cast<size_t>(i) * kCols * kMmaKc,
                kChunkBytes, &full[i]);
    }
  }
  const long long seg0 = lead0 + static_cast<long long>(n) * S;
  const int lead = stage_span(base, seg0 + static_cast<long long>(t0) * hop, span_len,
                              seg0 + S, s_x);
  cp_async_commit();
  if (scale != 1.0f) scale_span(s_x, (lead + span_len + 7) / 8 * 8, scale);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tq = (lane & 3) * 2;
  const int ra = lead + (warp * 16 + (lane >> 2)) * hop + tq;
  const int rb = ra + 8 * hop;
  const int rm = lead + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * hop + (lane >> 4) * 8;
  float acc[NT][4] = {};
  // Chunk i: wait for its B (and, first, the span); once every warp is
  // past chunk i - 2's MMAs, refill that stage with chunk i + kLookahead;
  // issue chunk i's MMAs (A in `cur`); then, once chunk i - 1's MMAs are
  // done, load chunk i + 1's A into `nxt` while chunk i's run.
  auto step = [&](int i, unsigned (&cur)[kSteps][4], unsigned (&nxt)[kSteps][4]) {
    if (i == 0) cp_async_wait_all();
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
    __syncthreads();
    const int ahead = i + kLookahead;
    if (threadIdx.x == 0 && ahead < kchunks) {
      bulk_load(ring + (ahead % kStages) * kCols * kMmaKc,
                wg + static_cast<size_t>(ahead) * kCols * kMmaKc, kChunkBytes,
                &full[ahead % kStages]);
    }
    if (i == 0) load_chunk_a<kLoad>(cur, s_x, ra, rb, rm, 0, kchunks, K, tq);
    issue_chunk<NT>(acc, cur, ring + (i % kStages) * kCols * kMmaKc);
    wgmma_wait<1>();
    fence_regs(nxt);
    if (i + 1 < kchunks) load_chunk_a<kLoad>(nxt, s_x, ra, rb, rm, i + 1, kchunks, K, tq);
  };
  unsigned a0[kSteps][4], a1[kSteps][4];
  for (int i = 0; i < kchunks; i += 2) {
    step(i, a0, a1);
    if (i + 1 < kchunks) step(i + 1, a1, a0);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(a0);
  fence_regs(a1);
  __syncthreads();  // the ring is free: it holds the output tile now

  const int pitch = tm + 8;
  stage_out<NT>(acc, ring, pitch, warp * 16 + (lane >> 2), tq, [eps](float y) {
    // y*y and +eps rounded separately, as the reference does (no FMA).
    return logf(__fadd_rn(__fmul_rn(y, y), eps));
  });
  __syncthreads();
  store_out(ring, pitch, kCols, tm, out, n, F, blockIdx.z * kCols, n_frames, t0);
}

// Two power values bf16(c*c + s*s), packed low-first: one A register.
__device__ __forceinline__ unsigned power_pair(float c0, float s0, float c1, float s1) {
  const __nv_bfloat162 v =
      __floats2bfloat162_rn(__fadd_rn(__fmul_rn(c0, c0), __fmul_rn(s0, s0)),
                            __fadd_rn(__fmul_rn(c1, c1), __fmul_rn(s1, s1)));
  return *reinterpret_cast<const unsigned*>(&v);
}

// macc[NTM] += bf16 power of the warpgroup's 64 frames x the chunk's 64
// bins, times the chunk's mel rows s_mel (NTM*8 mels x 64 bins, core
// matrix order), and wait for it. acc holds c in n-tiles 0-7 (bins
// 8q..8q+7) and s in n-tiles 8-15: the accumulator pair (2f, 2f+1) is the A
// fragment of bins 16f..16f+15.
template <int NTM>
__device__ __forceinline__ void mel_product(const float (&acc)[16][4],
                                            float (&macc)[NTM][4], const bf16* s_mel) {
  unsigned a[4][4];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const float(&c0)[4] = acc[2 * f];
    const float(&c1)[4] = acc[2 * f + 1];
    const float(&s0)[4] = acc[8 + 2 * f];
    const float(&s1)[4] = acc[8 + 2 * f + 1];
    a[f][0] = power_pair(c0[0], s0[0], c0[1], s0[1]);  // row g, bins 2t, 2t+1
    a[f][1] = power_pair(c0[2], s0[2], c0[3], s0[3]);  // row g+8
    a[f][2] = power_pair(c1[0], s1[0], c1[1], s1[1]);  // row g, bins 8+2t, 9+2t
    a[f][3] = power_pair(c1[2], s1[2], c1[3], s1[3]);  // row g+8
  }
  fence_regs(macc);
  wgmma_fence();
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    Wgmma<NTM>::run(macc, a[f], smem_desc(s_mel + f * 2 * (kCoreBytes / 2)));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(macc);
  fence_regs(a);
}

// B1 in bf16. Grid (frame tiles, N, mel groups); blockDim 32 x warps, 16
// frames per warp. bpack is [bchunks, kchunks, kStftCols, kMmaKc] (chunk j:
// cos of bins 64j..64j+63, then sin of the same bins), mpack is [groups,
// bchunks, NTM*8, kMmaKc] (the mel rows of chunk j's bins, transposed).
template <int NTM, int kLoad>
__global__ void __launch_bounds__(128 * kMaxWarpgroups)
    stft_melspec_mma_kernel(const bf16* __restrict__ base, int lead0,
                            const bf16* __restrict__ bpack, const bf16* __restrict__ mpack,
                            bf16* __restrict__ out, int S, int K, int hop, int M,
                            int n_frames, int kchunks, int bchunks, int span_len,
                            int span_alloc, float eps, float scale) {
  constexpr int kMels = NTM * 8;
  constexpr unsigned kChunkBytes = sizeof(bf16) * kStftCols * kMmaKc;
  constexpr unsigned kMelBytes = sizeof(bf16) * kMels * kMmaKc;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int tm = blockDim.x / 2;  // 64 frames per warpgroup of 128 threads
  bf16* s_x = reinterpret_cast<bf16*>(mma_smem);
  bf16* ring = s_x + span_alloc;  // [kStages][kStftCols * kMmaKc]; then the output tile
  bf16* s_mel = ring + ring_elems(kStftCols, kMels, tm);  // [kMels * kMmaKc]
  uint64_t* full = reinterpret_cast<uint64_t*>(s_mel + kMels * kMmaKc);  // the ring's, then s_mel's
  const int n = blockIdx.y;
  const int t0 = blockIdx.x * tm;
  const bf16* mg = mpack + static_cast<size_t>(blockIdx.z) * bchunks * kMels * kMmaKc;
  // Step st: bin chunk st / kchunks, tap chunk st % kchunks; bpack holds
  // the steps' chunks in this order.
  const int steps = bchunks * kchunks;
  if (threadIdx.x == 0) {
    for (int st = 0; st <= kStages; ++st) mbar_init(&full[st]);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int st = 0; st < kLookahead && st < steps; ++st) {
      bulk_load(ring + st * kStftCols * kMmaKc, bpack + static_cast<size_t>(st) * kStftCols * kMmaKc,
                kChunkBytes, &full[st]);
    }
  }
  const long long seg0 = lead0 + static_cast<long long>(n) * S;
  const int lead = stage_span(base, seg0 + static_cast<long long>(t0) * hop, span_len,
                              seg0 + S, s_x);
  cp_async_commit();
  if (scale != 1.0f) scale_span(s_x, (lead + span_len + 7) / 8 * 8, scale);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tq = (lane & 3) * 2;
  const int ra = lead + (warp * 16 + (lane >> 2)) * hop + tq;
  const int rb = ra + 8 * hop;
  const int rm = lead + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * hop + (lane >> 4) * 8;
  float acc[16][4] = {};
  float macc[NTM][4] = {};
  // As B2's steps; the first step of a bin chunk also loads its mel rows
  // (every warp is past the last mel product), and its last step waits for
  // all its MMAs, turns c and s into the power and runs the mel product.
  auto step = [&](int st, unsigned (&cur)[kSteps][4], unsigned (&nxt)[kSteps][4]) {
    const int i = st % kchunks;
    const int j = st / kchunks;
    if (st == 0) cp_async_wait_all();
    mbar_wait(&full[st % kStages], (st / kStages) & 1);
    __syncthreads();
    const int ahead = st + kLookahead;
    if (threadIdx.x == 0) {
      if (i == 0) bulk_load(s_mel, mg + static_cast<size_t>(j) * kMels * kMmaKc, kMelBytes,
                            &full[kStages]);
      if (ahead < steps) {
        bulk_load(ring + (ahead % kStages) * kStftCols * kMmaKc,
                  bpack + static_cast<size_t>(ahead) * kStftCols * kMmaKc, kChunkBytes,
                  &full[ahead % kStages]);
      }
    }
    if (st == 0) load_chunk_a<kLoad>(cur, s_x, ra, rb, rm, 0, kchunks, K, tq);
    issue_chunk<16>(acc, cur, ring + (st % kStages) * kStftCols * kMmaKc);
    if (i == kchunks - 1) {
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_wait(&full[kStages], j & 1);
      mel_product<NTM>(acc, macc, s_mel);
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
      }
    } else {
      wgmma_wait<1>();
    }
    fence_regs(nxt);
    if (st + 1 < steps) load_chunk_a<kLoad>(nxt, s_x, ra, rb, rm, (st + 1) % kchunks, kchunks, K, tq);
  };
  unsigned a0[kSteps][4], a1[kSteps][4];
  for (int st = 0; st < steps; st += 2) {
    step(st, a0, a1);
    if (st + 1 < steps) step(st + 1, a1, a0);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(a0);
  fence_regs(a1);
  __syncthreads();  // the ring is free: it holds the output tile now
  const int pitch = tm + 8;
  stage_out<NTM>(macc, ring, pitch, warp * 16 + (lane >> 2), tq,
                 [eps](float v) { return logf(__fadd_rn(v, eps)); });
  __syncthreads();
  store_out(ring, pitch, kMels, tm, out, n, M, blockIdx.z * kMels, n_frames, t0);
}

// ---------------------------------------------------------------------------
// B5: split-TF32 tensor-core kernel
// ---------------------------------------------------------------------------

// B5's B operand streams in chunks of 32 taps: 128 bytes of f32 per column,
// the byte geometry of a 64-tap bf16 chunk, so smem_desc's offsets hold.
// The host packs it so (ops/cuda/frontend.py, TF32_TAPS).
constexpr int kTf32Kc = 32;
constexpr int kTf32Steps = kTf32Kc / 8;  // k8 steps per chunk

// x rounded to TF32 (10 mantissa bits, round to nearest, ties away): the
// tensor cores ignore an f32 operand's low 13 bits, so the rounding is
// explicit.
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d[NT][4] += a (this warp's 16 of the warpgroup's 64 rows, 8 taps, TF32 in
// registers) x B (8 taps x NT * 8 columns at desc): the m64nNk8 TF32 wgmma
// with f32 accumulators, asynchronously.
template <int NT>
struct WgmmaTf32;

template <>
struct WgmmaTf32<4> {
  static __device__ __forceinline__ void run(float (&d)[4][4], const unsigned (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct WgmmaTf32<8> {
  static __device__ __forceinline__ void run(float (&d)[8][4], const unsigned (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct WgmmaTf32<12> {
  static __device__ __forceinline__ void run(float (&d)[12][4], const unsigned (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct WgmmaTf32<16> {
  static __device__ __forceinline__ void run(float (&d)[16][4], const unsigned (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};


// One staged sample, scaled as the plain version scales it.
__device__ __forceinline__ float sample_f32(const float* s, int i, float scale) {
  return __fmul_rn(s[i], scale);
}
__device__ __forceinline__ float sample_f32(const short* s, int i, float scale) {
  return __fmul_rn(static_cast<float>(s[i]), scale);
}

// This thread's A fragments of one 32-tap chunk from kb on, split in
// registers: x = big + small, big = tf32(x), small = tf32(x - big). Rows
// outside the tile (ok false) and taps at or past K give 0; for int16
// input, big + small is x exactly (16 significant bits).
template <typename T>
__device__ __forceinline__ void load_chunk_tf32(unsigned (&big)[kTf32Steps][4],
                                                unsigned (&small)[kTf32Steps][4],
                                                const T* s, int ra, int rb, bool ok_a,
                                                bool ok_b, int kb, int K, int tq,
                                                float scale) {
#pragma unroll
  for (int kk = 0; kk < kTf32Steps; ++kk) {
    const int k0 = kb + kk * 8 + tq;
    // a0: (row g, tap t), a1: (row g + 8, tap t), a2, a3: tap t + 4.
    const bool use[4] = {ok_a && k0 < K, ok_b && k0 < K, ok_a && k0 + 4 < K,
                         ok_b && k0 + 4 < K};
    const int at[4] = {ra + k0, rb + k0, ra + k0 + 4, rb + k0 + 4};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = use[e] ? sample_f32(s, at[e], scale) : 0.0f;
      big[kk][e] = to_tf32(v);
      small[kk][e] = to_tf32(__fsub_rn(v, __uint_as_float(big[kk][e])));
    }
  }
}

// acc += the chunk's 3xTF32 product: small(A) big(W) + big(A) small(W) +
// big(A) big(W) per k8 step (the small terms first), twelve wgmma committed
// as one group and left in flight. stage holds w_big's NT*8 x 32 core
// matrices, then w_small's.
template <int NT>
__device__ __forceinline__ void issue_chunk_tf32(float (&acc)[NT][4],
                                                 const unsigned (&big)[kTf32Steps][4],
                                                 const unsigned (&small)[kTf32Steps][4],
                                                 const float* stage) {
  const float* w_big = stage;
  const float* w_small = stage + NT * 8 * kTf32Kc;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTf32Steps; ++kk) {
    const int off = kk * 2 * (kCoreBytes / sizeof(float));  // two core matrices of 8 x 4
    WgmmaTf32<NT>::run(acc, small[kk], smem_desc(w_big + off));
    WgmmaTf32<NT>::run(acc, big[kk], smem_desc(w_small + off));
    WgmmaTf32<NT>::run(acc, big[kk], smem_desc(w_big + off));
  }
  wgmma_commit();
}

// B5: out[n, t, f] = log(y*y + eps), y = sum_k (scale * audio[n * step +
// t * hop + k]) * w[f, k], the product in split TF32 with f32 sums. Grid
// (frame tiles, n, column groups); blockDim 128 x warpgroups; each
// warpgroup covers `rows` frames (64, or 32 or 16 where a large hop's span
// would not fit: the other rows of its m64 tile are zero and not stored).
// The span stays in the input's type (int16 or f32) and is scaled and split
// as the A fragments load. wpack is [groups, kchunks, 2, NT*8, 32] in core
// matrix order (w_big | w_small per chunk).
template <typename T, int NT>
__global__ void __launch_bounds__(128 * kMaxWarpgroups)
    frame_filterbank_tf32_kernel(const T* __restrict__ base, long long lead0,
                                 long long audio_len, const float* __restrict__ wpack,
                                 float* __restrict__ out, int step, int K, int hop, int F,
                                 int n_frames, int kchunks, int rows, int span_len,
                                 int span_bytes, float eps, float scale) {
  constexpr int kCols = NT * 8;
  constexpr int kChunkFloats = 2 * kCols * kTf32Kc;
  constexpr unsigned kChunkBytes = sizeof(float) * kChunkFloats;
  extern __shared__ __align__(128) unsigned char mma_smem[];
  T* s_x = reinterpret_cast<T*>(mma_smem);
  float* ring = reinterpret_cast<float*>(mma_smem + span_bytes);  // [kStages][kChunkFloats]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kChunkFloats);
  const int n = blockIdx.y;
  const int t0 = blockIdx.x * (blockDim.x / 128) * rows;
  const float* wg = wpack + static_cast<size_t>(blockIdx.z) * kchunks * kChunkFloats;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st]);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < kLookahead && i < kchunks; ++i) {
      bulk_load(ring + i * kChunkFloats, wg + static_cast<size_t>(i) * kChunkFloats,
                kChunkBytes, &full[i]);
    }
  }
  const long long start = lead0 + static_cast<long long>(n) * step +
                          static_cast<long long>(t0) * hop;
  const int lead = stage_span(base, start, span_len, lead0 + audio_len, s_x);
  cp_async_commit();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tq = lane & 3;
  const int lr = (warp & 3) * 16 + (lane >> 2);  // this thread's row in its warpgroup
  const bool ok_a = lr < rows;
  const bool ok_b = lr + 8 < rows;
  const int fa = (warp >> 2) * rows + lr;  // its frame in the tile (and fa + 8)
  const int ra = lead + fa * hop;
  const int rb = ra + 8 * hop;
  float acc[NT][4] = {};
  // B2's ring schedule: chunk i waits for its B (and, first, the span);
  // once every warp is past chunk i - 2's MMAs, that stage is refilled with
  // chunk i + kLookahead; chunk i's MMAs are issued, and chunk i + 1's A
  // fragments load and split while they run.
  auto step_chunk = [&](int i, unsigned (&cb)[kTf32Steps][4], unsigned (&cs)[kTf32Steps][4],
                        unsigned (&nb)[kTf32Steps][4], unsigned (&ns)[kTf32Steps][4]) {
    if (i == 0) cp_async_wait_all();
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
    __syncthreads();
    const int ahead = i + kLookahead;
    if (threadIdx.x == 0 && ahead < kchunks) {
      bulk_load(ring + (ahead % kStages) * kChunkFloats,
                wg + static_cast<size_t>(ahead) * kChunkFloats, kChunkBytes,
                &full[ahead % kStages]);
    }
    if (i == 0) load_chunk_tf32(cb, cs, s_x, ra, rb, ok_a, ok_b, 0, K, tq, scale);
    issue_chunk_tf32<NT>(acc, cb, cs, ring + (i % kStages) * kChunkFloats);
    wgmma_wait<1>();
    fence_regs(nb);
    fence_regs(ns);
    if (i + 1 < kchunks) {
      load_chunk_tf32(nb, ns, s_x, ra, rb, ok_a, ok_b, (i + 1) * kTf32Kc, K, tq, scale);
    }
  };
  unsigned b0[kTf32Steps][4], s0[kTf32Steps][4], b1[kTf32Steps][4], s1[kTf32Steps][4];
  for (int i = 0; i < kchunks; i += 2) {
    step_chunk(i, b0, s0, b1, s1);
    if (i + 1 < kchunks) step_chunk(i + 1, b1, s1, b0, s0);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // [n, T, F] straight from the accumulators: per n-tile, a warp writes 8
  // frames x 8 adjacent filters (whole 32-byte sectors when F is even).
  const int col0 = blockIdx.z * kCols + 2 * tq;
  const int frame[2] = {t0 + fa, t0 + fa + 8};
  const bool ok[2] = {ok_a && frame[0] < n_frames, ok_b && frame[1] < n_frames};
  const auto fn = [eps](float y) {
    // y*y and +eps rounded separately, as the reference does (no FMA).
    return logf(__fadd_rn(__fmul_rn(y, y), eps));
  };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!ok[h]) continue;
    float* row = out + (static_cast<size_t>(n) * n_frames + frame[h]) * F;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = col0 + j * 8;
      const float v0 = fn(acc[j][2 * h]), v1 = fn(acc[j][2 * h + 1]);
      if (col + 1 < F && (F & 1) == 0) {
        *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
      } else {
        if (col < F) row[col] = v0;
        if (col + 1 < F) row[col + 1] = v1;
      }
    }
  }
}

int round_up_threads(int items) {
  const int t = (items + 31) / 32 * 32;
  return t < 1024 ? t : 1024;
}

// The geometry of a tensor-core launch: the input's 16-byte-aligned base and
// the offset of its first element from it, the warpgroups per CTA (two,
// or one where a large hop's span would not fit beside the ring), and the
// span a CTA stages (its allocation rounded to 128 bytes, so that the B
// ring after it is aligned).
struct MmaPlan {
  const bf16* base;
  int lead0;
  int warpgroups;
  int span_len;
  int span_alloc;
  size_t smem;
  int load;  // ALoad
};

// Returned when even one warpgroup's 64 frames do not fit in shared memory
// beside the B ring (bn_frontend_bf16_max_hop gives the limit: 1209 for B1
// and 1437 for B2 at 1024 taps and 96 mels or filters).
constexpr int kSpanTooLarge = -1;

// A CTA's shared bytes besides the span, for tile_rows frames and cols
// columns: B2's ring (which then holds the [cols, tile_rows + 8] output
// tile) and its mbarriers; B1's ring, the mel rows and one more mbarrier.
size_t mma_extra_smem(bool stft, int cols, int tile_rows) {
  if (stft) {
    return sizeof(bf16) * (ring_elems(kStftCols, cols, tile_rows) + cols * kMmaKc) +
           sizeof(uint64_t) * (kStages + 1);
  }
  return sizeof(bf16) * ring_elems(cols, cols, tile_rows) + sizeof(uint64_t) * kStages;
}

bool plan_mma(const void* seg, int S, int K, int hop, bool stft, int cols, MmaPlan* plan) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(seg);
  plan->base = reinterpret_cast<const bf16*>(p & ~static_cast<uintptr_t>(15));
  plan->lead0 = static_cast<int>((p & 15) >> 1);
  plan->load = hop % 8 == 0 && S % 8 == 0 && plan->lead0 == 0 ? kMatrix : kHalves;
  for (int wgs = kMaxWarpgroups; wgs >= 1; --wgs) {
    const long long span = static_cast<long long>(64 * wgs - 1) * hop +
                           (K + kMmaKc - 1) / kMmaKc * kMmaKc;
    const long long alloc = (7 + span + 63) / 64 * 64;
    plan->warpgroups = wgs;
    plan->span_len = static_cast<int>(span);
    plan->span_alloc = static_cast<int>(alloc);
    plan->smem = sizeof(bf16) * static_cast<size_t>(alloc) + mma_extra_smem(stft, cols, 64 * wgs);
    if (plan->smem <= kMaxSmem) return true;
  }
  return false;
}

template <int NT, int kLoad>
int launch_filterbank_mma(const MmaPlan& pl, const void* wpack, void* out, int N, int S,
                          int K, int hop, int F, int groups, int n_frames, float eps,
                          float scale, cudaStream_t stream) {
  auto kernel = filterbank_logpower_mma_kernel<NT, kLoad>;
  cudaError_t err = set_smem(kernel, pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile_rows = 64 * pl.warpgroups;
  const dim3 grid((n_frames + tile_rows - 1) / tile_rows, N, groups);
  kernel<<<grid, 128 * pl.warpgroups, pl.smem, stream>>>(
      pl.base, pl.lead0, static_cast<const bf16*>(wpack), static_cast<bf16*>(out), S, K,
      hop, F, n_frames, (K + kMmaKc - 1) / kMmaKc, pl.span_len, pl.span_alloc, eps, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int dispatch_filterbank_mma(const MmaPlan& pl, const void* wpack, void* out, int N,
                            int S, int K, int hop, int F, int groups, int n_frames,
                            float eps, float scale, cudaStream_t stream) {
  if (pl.load == kMatrix) {
    return launch_filterbank_mma<NT, kMatrix>(pl, wpack, out, N, S, K, hop, F, groups,
                                              n_frames, eps, scale, stream);
  }
  return launch_filterbank_mma<NT, kHalves>(pl, wpack, out, N, S, K, hop, F, groups,
                                            n_frames, eps, scale, stream);
}

template <int NTM, int kLoad>
int launch_stft_mma(const MmaPlan& pl, const void* bpack, const void* mpack, void* out,
                    int N, int S, int K, int hop, int M, int bchunks, int groups,
                    int n_frames, float eps, float scale, cudaStream_t stream) {
  auto kernel = stft_melspec_mma_kernel<NTM, kLoad>;
  cudaError_t err = set_smem(kernel, pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile_rows = 64 * pl.warpgroups;
  const dim3 grid((n_frames + tile_rows - 1) / tile_rows, N, groups);
  kernel<<<grid, 128 * pl.warpgroups, pl.smem, stream>>>(
      pl.base, pl.lead0, static_cast<const bf16*>(bpack), static_cast<const bf16*>(mpack),
      static_cast<bf16*>(out), S, K, hop, M, n_frames, (K + kMmaKc - 1) / kMmaKc, bchunks,
      pl.span_len, pl.span_alloc, eps, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NTM>
int dispatch_stft_mma(const MmaPlan& pl, const void* bpack, const void* mpack, void* out,
                      int N, int S, int K, int hop, int M, int bchunks, int groups,
                      int n_frames, float eps, float scale, cudaStream_t stream) {
  if (pl.load == kMatrix) {
    return launch_stft_mma<NTM, kMatrix>(pl, bpack, mpack, out, N, S, K, hop, M, bchunks,
                                         groups, n_frames, eps, scale, stream);
  }
  return launch_stft_mma<NTM, kHalves>(pl, bpack, mpack, out, N, S, K, hop, M, bchunks,
                                       groups, n_frames, eps, scale, stream);
}

// The geometry of a B5 launch: the input's 16-byte-aligned base and its
// first element's offset from it; warpgroups per CTA and the frames each
// covers (two of 64, else one of 64, 32 or 16, the first whose span fits
// beside the B ring); the span a CTA stages and its allocation in bytes
// (a multiple of 128, so that the ring after it is aligned).
struct Tf32Plan {
  const void* base;
  long long lead0;
  int warpgroups;
  int rows;
  int span_len;
  int span_bytes;
  size_t smem;
};

bool plan_tf32(const void* audio, int elem, int K, int hop, int cols, Tf32Plan* pl) {
  static const int kShapes[][2] = {{2, 64}, {1, 64}, {1, 32}, {1, 16}};
  const uintptr_t p = reinterpret_cast<uintptr_t>(audio);
  pl->base = reinterpret_cast<const void*>(p & ~static_cast<uintptr_t>(15));
  pl->lead0 = static_cast<long long>((p & 15) / elem);
  const size_t ring = sizeof(float) * kStages * 2 * cols * kTf32Kc + sizeof(uint64_t) * kStages;
  const long long taps = (K + kTf32Kc - 1) / kTf32Kc * kTf32Kc;
  for (const auto& shape : kShapes) {
    const long long span = static_cast<long long>(shape[0] * shape[1] - 1) * hop + taps;
    const long long bytes = ((16 / elem - 1 + span) * elem + 127) / 128 * 128;
    if (static_cast<size_t>(bytes) + ring > kMaxSmem) continue;
    pl->warpgroups = shape[0];
    pl->rows = shape[1];
    pl->span_len = static_cast<int>(span);
    pl->span_bytes = static_cast<int>(bytes);
    pl->smem = static_cast<size_t>(bytes) + ring;
    return true;
  }
  return false;
}

template <typename T, int NT>
int launch_frame_tf32(const Tf32Plan& pl, const void* wpack, void* out, int N,
                      long long audio_len, int step, int K, int hop, int F, int groups,
                      int n_frames, float eps, float scale, cudaStream_t stream) {
  auto kernel = frame_filterbank_tf32_kernel<T, NT>;
  cudaError_t err = set_smem(kernel, pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile = pl.warpgroups * pl.rows;
  const dim3 grid((n_frames + tile - 1) / tile, N, groups);
  kernel<<<grid, 128 * pl.warpgroups, pl.smem, stream>>>(
      static_cast<const T*>(pl.base), pl.lead0, audio_len, static_cast<const float*>(wpack),
      static_cast<float*>(out), step, K, hop, F, n_frames, (K + kTf32Kc - 1) / kTf32Kc,
      pl.rows, pl.span_len, pl.span_bytes, eps, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_frame_tf32(const void* audio, const void* wpack, void* out, int N,
                        long long audio_len, int step, int K, int hop, int F, int cols,
                        int groups, int n_frames, float eps, float scale,
                        cudaStream_t s) {
  Tf32Plan pl;
  if (!plan_tf32(audio, sizeof(T), K, hop, cols, &pl)) return kSpanTooLarge;
  switch (cols) {
    case 32: return launch_frame_tf32<T, 4>(pl, wpack, out, N, audio_len, step, K, hop, F, groups, n_frames, eps, scale, s);
    case 64: return launch_frame_tf32<T, 8>(pl, wpack, out, N, audio_len, step, K, hop, F, groups, n_frames, eps, scale, s);
    case 96: return launch_frame_tf32<T, 12>(pl, wpack, out, N, audio_len, step, K, hop, F, groups, n_frames, eps, scale, s);
    case 128: return launch_frame_tf32<T, 16>(pl, wpack, out, N, audio_len, step, K, hop, F, groups, n_frames, eps, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int bn_filterbank_logpower_f32(const void* seg, const void* wt, void* out,
                                          int N, int S, int K, int hop, int F,
                                          int n_frames, float eps, float scale,
                                          void* stream) {
  const size_t smem = sizeof(float) * tile_span(hop, K);
  cudaError_t err = set_smem(filterbank_logpower_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + kTileFrames - 1) / kTileFrames, N);
  const int half = (F + kColsPerThread - 1) / kColsPerThread;
  const int threads = round_up_threads(half * (kTileFrames / kFbFramesPerThread));
  filterbank_logpower_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(seg), static_cast<const float*>(wt),
      static_cast<float*>(out), S, K, hop, F, n_frames, eps, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_stft_melspec_f32(const void* seg, const void* bc, const void* bs,
                                   const void* mel, void* out, int N, int S, int flen,
                                   int hop, int bins, int M, int n_frames, float eps,
                                   float scale, void* stream) {
  const size_t smem =
      sizeof(float) * (tile_span(hop, flen) + static_cast<size_t>(kTileFrames) * bins);
  cudaError_t err = set_smem(stft_melspec_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + kTileFrames - 1) / kTileFrames, N);
  const int half = (bins + kColsPerThread - 1) / kColsPerThread;
  const int threads = round_up_threads(half * (kTileFrames / kStftFramesPerThread));
  stft_melspec_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(seg), static_cast<const float*>(bc),
      static_cast<const float*>(bs), static_cast<const float*>(mel),
      static_cast<float*>(out), S, flen, hop, bins, M, n_frames, eps, scale);
  return static_cast<int>(cudaGetLastError());
}

// wpack: [groups, ceil(K/64), cols, 64] bf16 with cols in {32, 64, 96, 128}.
extern "C" int bn_filterbank_logpower_bf16(const void* seg, const void* wpack, void* out,
                                           int N, int S, int K, int hop, int F, int cols,
                                           int groups, int n_frames, float eps,
                                           float scale, void* stream) {
  MmaPlan pl;
  if (!plan_mma(seg, S, K, hop, false, cols, &pl)) return kSpanTooLarge;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cols) {
    case 32: return dispatch_filterbank_mma<4>(pl, wpack, out, N, S, K, hop, F, groups, n_frames, eps, scale, s);
    case 64: return dispatch_filterbank_mma<8>(pl, wpack, out, N, S, K, hop, F, groups, n_frames, eps, scale, s);
    case 96: return dispatch_filterbank_mma<12>(pl, wpack, out, N, S, K, hop, F, groups, n_frames, eps, scale, s);
    case 128: return dispatch_filterbank_mma<16>(pl, wpack, out, N, S, K, hop, F, groups, n_frames, eps, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bpack: [bchunks, ceil(K/64), 128, 64]; mpack: [groups, bchunks, cols, 64]
// bf16 with cols in {32, 64, 96, 128}.
extern "C" int bn_stft_melspec_bf16(const void* seg, const void* bpack, const void* mpack,
                                    void* out, int N, int S, int K, int hop, int M,
                                    int bchunks, int cols, int groups, int n_frames,
                                    float eps, float scale, void* stream) {
  MmaPlan pl;
  if (!plan_mma(seg, S, K, hop, true, cols, &pl)) return kSpanTooLarge;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cols) {
    case 32: return dispatch_stft_mma<4>(pl, bpack, mpack, out, N, S, K, hop, M, bchunks, groups, n_frames, eps, scale, s);
    case 64: return dispatch_stft_mma<8>(pl, bpack, mpack, out, N, S, K, hop, M, bchunks, groups, n_frames, eps, scale, s);
    case 96: return dispatch_stft_mma<12>(pl, bpack, mpack, out, N, S, K, hop, M, bchunks, groups, n_frames, eps, scale, s);
    case 128: return dispatch_stft_mma<16>(pl, bpack, mpack, out, N, S, K, hop, M, bchunks, groups, n_frames, eps, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The largest hop the bf16 kernel of B1 (stft != 0) or B2 takes at K taps
// and cols columns per CTA: above it bn_*_bf16 return kSpanTooLarge.
extern "C" int bn_frontend_bf16_max_hop(int stft, int K, int cols) {
  MmaPlan pl;
  int hop = 0;
  while (plan_mma(nullptr, 0, K, hop + 1, stft != 0, cols, &pl)) ++hop;
  return hop;
}

// in_dtype: 0 = float32, 1 = int16 audio. wpack: [groups, ceil(K/32), 2,
// cols, 32] float32 (w_big | w_small, core matrix order) with cols in {32,
// 64, 96, 128}; out float32 [N, n_frames, F].
extern "C" int bn_frame_filterbank_logpower(int in_dtype, const void* audio,
                                            const void* wpack, void* out, int N,
                                            long long audio_len, int step, int K,
                                            int hop, int F, int cols, int groups,
                                            int n_frames, float eps, float scale,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0) {
    return dispatch_frame_tf32<float>(audio, wpack, out, N, audio_len, step, K, hop, F,
                                      cols, groups, n_frames, eps, scale, s);
  }
  return dispatch_frame_tf32<short>(audio, wpack, out, N, audio_len, step, K, hop, F, cols,
                                    groups, n_frames, eps, scale, s);
}

// The largest hop B5 takes for in_dtype's samples at K taps and cols
// columns per CTA: above it bn_frame_filterbank_logpower returns
// kSpanTooLarge.
extern "C" int bn_frame_filterbank_max_hop(int in_dtype, int K, int cols) {
  Tf32Plan pl;
  const int elem = in_dtype == 0 ? 4 : 2;
  int hop = 0;
  while (plan_tf32(nullptr, elem, K, hop + 1, cols, &pl)) ++hop;
  return hop;
}
