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
// and one byte out per element and do 2 * C_in operations per output: most
// are bound by device memory (24 -> 96 over 48 x 256 at ~48 operations per
// byte, far below the int8 ridge of ~590); the widest (320 -> 1280 and
// 1280 -> 320 at small N) do more work per byte. The squeeze-excite convs
// (N = 1) are tiny and bound by latency.
//
// The design. All positions of the batch form one GEMM dimension: M is the
// flattened (b, n), so an N = 1 conv fills a tile with the batch's images.
// The product runs on the tensor cores as wgmma.m64nNk32.s32.s8.s8 with A
// (positions x channels) from registers and B (w, K-major as it stands,
// padded on the host to 32-channel chunks and to the CTA's column tile of
// 16, 32, 48 or 64 output channels, cached) from shared memory:
//   - one CTA (one warpgroup) per (128 positions, column tile); each thread
//     owns four consecutive positions, as rows g and g + 8 of two m64
//     tiles (a partial last tile, as every N = 1 conv's, shares its
//     requantize among all four warps through shared memory);
//   - per 32-channel chunk the x tile [32 channels, 128 positions] is
//     staged with cp.async (16-byte pieces where N % 16 == 0, 4-byte where
//     N % 4 == 0, bytes otherwise), rows XOR-swizzled so that the fragment
//     reads are free of bank conflicts; for N = 1, where x is [B, C_in] and
//     already K-major, the tile is staged as [128 positions, 32 channels];
//   - a thread builds its A fragments with four 32-bit reads per 16
//     channels and a 4 x 4 byte transpose (prmt): the channel quad of each
//     of its four positions;
//   - w's chunks stream through a 6-stage ring of bulk copies (the TMA, one
//     thread issuing, an mbarrier per stage), x's through the same stages;
//     one wgmma group stays in flight while the next chunk's fragments load;
//   - the epilogue keeps the int32 sum and the requantize in registers
//     (an estimate decides each code where it provably can, the exact
//     steps elsewhere; see estimate_q) and stores each output channel's
//     four codes as one 32-bit word: a warp writes whole 32-byte runs
//     along n.
//
// Plain C entry point, loaded with ctypes: it launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;              // one warpgroup
constexpr int kTileP = 128;                // positions per CTA: two m64 tiles
constexpr int kKc = 32;                    // input channels per chunk: one k32 step
constexpr int kStages = 6;                 // ring depth
constexpr int kLookahead = kStages - 2;    // chunks in flight ahead of the one the MMAs read
constexpr int kXStageBytes = kKc * kTileP;  // 4 KB

// Activation codes, as ops/cuda/qconv.py passes them.
enum Act : int { kNone = 0, kRelu = 1, kSigmoid = 2, kSilu = 3, kTanh = 4 };

__device__ __forceinline__ float sigmoid_rn(float v) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-v)));  // 1 / x rounded once, as a division
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

// The requantize epilogue. v = f32(acc + bias) * scale (the int32 add
// wrapping as the reference's), then the exact steps, each rounded on its
// own: q = act(v) / y_scale, the code saturate(rint(q)).
__device__ __forceinline__ float dequant(int acc, unsigned bias, float scale) {
  const int s = static_cast<int>(static_cast<unsigned>(acc) + bias);
  return __fmul_rn(__int2float_rn(s), scale);
}

__device__ __forceinline__ float exact_q(float v, float y_scale, int act) {
  return __fdiv_rn(activate(v, act), y_scale);
}

// The IEEE division and reciprocal carry slow-path branches, which keep the
// compiler from interleaving the elements' chains, and they dominated the
// kernel's time. So an estimate comes first: the same expf, the
// reciprocals of 1 + exp(-v) and of y_scale from rcp.approx (within 1 ulp),
// then products. Its quotient lies within about 5 ulp of exact_q's, under
// 2^-13.8 where |q| < 130: wherever the estimate is farther than
// kDecideMargin from every rounding boundary k + 1/2, or saturates, both
// give the same code; elsewhere (about 5e-4 of the codes) exact_q decides.
// tanh has no estimate.
constexpr float kDecideMargin = 1.0f / 4096.0f;
constexpr float kSaturate = 130.0f;

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float estimate_q(float v, float inv_y, int act) {
  float a = v;
  if (act == kRelu) a = v < 0.0f ? 0.0f : v;
  if (act == kSigmoid) a = rcp_approx(__fadd_rn(1.0f, expf(-v)));
  if (act == kSilu) a = __fmul_rn(v, rcp_approx(__fadd_rn(1.0f, expf(-v))));
  return __fmul_rn(a, inv_y);
}

__device__ __forceinline__ bool decides(float q, int act) {
  return act != kTanh &&
         (fabsf(q) >= kSaturate || fabsf(__fsub_rn(q, floorf(q)) - 0.5f) > kDecideMargin);
}

__device__ __forceinline__ unsigned code_of(float q) {
  const float c = fminf(fmaxf(rintf(q), -128.0f), 127.0f);
  return static_cast<unsigned>(__float2int_rn(c)) & 0xFFu;
}

// d[NT][4] = a (this warp's 16 of the m64 tile's rows, 32 channels, int8
// in registers) x B (32 channels x NT * 8 output channels at desc), plus d
// unless scale_d is 0: the m64nNk32 s8 wgmma with s32 accumulators,
// asynchronously. d[j] holds columns 8j..8j+7 in mma.sync's accumulator
// layout. The first chunk passes scale_d 0, so the accumulators need no
// zeroing (instructions that define them between wgmma would serialize
// the MMAs).
template <int NT>
struct WgmmaS8;

template <>
struct WgmmaS8<2> {
  static __device__ __forceinline__ void run(int (&d)[2][4], const unsigned (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p;\n"
        "}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<4> {
  static __device__ __forceinline__ void run(int (&d)[4][4], const unsigned (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p;\n"
        "}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]), "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<6> {
  static __device__ __forceinline__ void run(int (&d)[6][4], const unsigned (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p;\n"
        "}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]), "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]), "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<8> {
  static __device__ __forceinline__ void run(int (&d)[8][4], const unsigned (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p;\n"
        "}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]), "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]), "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]), "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};


// The swizzle of a channel-major x tile: word j (positions 4j..4j+3) of
// channel row ch sits at j ^ xor_of(ch), so that the eight positions-words
// x four channel rows a warp's fragment reads hit 32 distinct banks.
__device__ __forceinline__ int xor_of(int ch) { return 8 * ((ch >> 2) & 3); }

// Stage chunk c's x tile (channels 32c..32c+31 of positions p0..p0+127) in
// xs, zero past C_in and past P, issuing cp.async without committing:
//   - channel-major ([32 channels][128 positions], rows swizzled), x being
//     [B, C_in, N]: position p is (b, n) = (p / N, p % N); pieces of 16 or
//     4 positions (piece 16 or 4, never straddling an image), or bytes;
//   - K-major ([128 positions][32 channels]) where N == 1 (kmajor): x is
//     [P, C_in]; pieces of 16 or 4 channels, or bytes.
__device__ __forceinline__ void stage_x(const int8_t* __restrict__ x, unsigned char* xs,
                                        int c, int p0, int P, int C_in, int N, int piece,
                                        bool kmajor) {
  const int k0 = c * kKc;
  unsigned* xw = reinterpret_cast<unsigned*>(xs);
  if (kmajor) {
    const int per = piece == 1 ? 1 : piece;  // channels per copy
    const int copies = kTileP * kKc / per;
    for (int q = threadIdx.x; q < copies; q += kThreads) {
      const int pos = q / (kKc / per);
      const int ch = (q % (kKc / per)) * per;
      const int p = p0 + pos, k = k0 + ch;
      const bool ok = p < P && k < C_in;
      const int8_t* src = x + (ok ? static_cast<size_t>(p) * C_in + k : 0);
      if (piece == 16) {
        cp_async16(xs + pos * kKc + ch, src, ok ? 16 : 0);
      } else if (piece == 4) {
        cp_async4(xs + pos * kKc + ch, src, ok ? 4 : 0);
      } else {
        xs[pos * kKc + ch] = ok ? static_cast<unsigned char>(*src) : 0;
      }
    }
    return;
  }
  const int copies = kKc * kTileP / piece;
  for (int q = threadIdx.x; q < copies; q += kThreads) {
    const int ch = q / (kTileP / piece);
    const int pos = (q % (kTileP / piece)) * piece;
    const int p = p0 + pos, k = k0 + ch;
    const bool ok = p < P && k < C_in;
    const int b = ok ? p / N : 0;
    const int8_t* src = x + (ok ? (static_cast<size_t>(b) * C_in + k) * N + (p - b * N) : 0);
    const int word = ch * (kTileP / 4) + ((pos >> 2) ^ xor_of(ch));
    if (piece == 16) {
      cp_async16(xw + word, src, ok ? 16 : 0);
    } else if (piece == 4) {
      cp_async4(xw + word, src, ok ? 4 : 0);
    } else {
      xs[4 * word + (pos & 3)] = ok ? static_cast<unsigned char>(*src) : 0;
    }
  }
}

// q[i] = byte i of r[0], r[1], r[2], r[3], low byte first: four words of
// four positions of one channel each become four words of four channels of
// one position each.
__device__ __forceinline__ void transpose4x4(const unsigned (&r)[4], unsigned (&q)[4]) {
  const unsigned lo01 = __byte_perm(r[0], r[1], 0x5140), lo23 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned hi01 = __byte_perm(r[0], r[1], 0x7362), hi23 = __byte_perm(r[2], r[3], 0x7362);
  q[0] = __byte_perm(lo01, lo23, 0x5410);
  q[1] = __byte_perm(lo01, lo23, 0x7632);
  q[2] = __byte_perm(hi01, hi23, 0x5410);
  q[3] = __byte_perm(hi01, hi23, 0x7632);
}

// This thread's A fragments of one chunk: a[tile][4] for its positions
// 32 warp + 4 g + i, i = 0..3, which are rows g (i = 0, 2) and g + 8
// (i = 1, 3) of m64 tile i / 2; registers 0-1 hold channels 4t..4t+3,
// 2-3 channels 16 + 4t..16 + 4t + 3.
__device__ __forceinline__ void load_a_s8(unsigned (&a)[2][4], const unsigned char* xs,
                                          int warp, int g, int t, bool kmajor) {
  const unsigned* xw = reinterpret_cast<const unsigned*>(xs);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned q[4];
    if (kmajor) {
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = xw[(32 * warp + 4 * g + i) * (kKc / 4) + 4 * h + t];
    } else {
      // Rows 16h + 4t + c all carry the swizzle xor_of = 8t.
      const int word = (8 * warp + g) ^ (8 * t);
      unsigned r[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) r[c] = xw[(16 * h + 4 * t + c) * (kTileP / 4) + word];
      transpose4x4(r, q);
    }
    a[0][2 * h] = q[0];
    a[0][2 * h + 1] = q[1];
    a[1][2 * h] = q[2];
    a[1][2 * h + 1] = q[3];
  }
}

// Grid (position tiles of 128, column tiles of NT * 8); 128 threads.
// wpack is [column tiles, kchunks, NT, 2, 8, 16]: per 32-channel chunk,
// NT * 8 rows of w as core matrices of 8 rows x 16 channels.
template <int NT>
__global__ void __launch_bounds__(kThreads)
    qconv1x1_requant_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wpack,
                            const int32_t* __restrict__ bias, const float* __restrict__ scale,
                            int8_t* __restrict__ out, int C_in, int C_out, int N, int P,
                            int kchunks, int piece, int kmajor, float y_scale, int act) {
  constexpr int kCols = NT * 8;
  constexpr unsigned kWBytes = kCols * kKc;
  extern __shared__ __align__(128) unsigned char q_smem[];
  unsigned char* xring = q_smem;                              // [kStages][kXStageBytes]
  unsigned char* wring = q_smem + kStages * kXStageBytes;     // [kStages][kWBytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(wring + kStages * kWBytes);
  __shared__ float s_scale[kCols];
  __shared__ unsigned s_bias[kCols];
  const int8_t* wt = wpack + static_cast<size_t>(blockIdx.y) * kchunks * kWBytes;
  const int p0 = blockIdx.x * kTileP;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st]);
    fence_mbar_init();
  }
  __syncthreads();
  auto load_chunk = [&](int i) {
    if (i < kchunks) {
      if (threadIdx.x == 0) {
        bulk_load(wring + (i % kStages) * kWBytes, wt + static_cast<size_t>(i) * kWBytes,
                  kWBytes, &full[i % kStages]);
      }
      stage_x(x, xring + (i % kStages) * kXStageBytes, i, p0, P, C_in, N, piece, kmajor != 0);
    }
    cp_async_commit();  // one group per chunk, empty past the last
  };
  for (int i = 0; i < kLookahead; ++i) load_chunk(i);
  // The epilogue's per-channel bias and scale, read once per CTA while the
  // first chunks load (visible after the first step's barrier).
  if (threadIdx.x < kCols) {
    const int m = blockIdx.y * kCols + threadIdx.x;
    s_scale[threadIdx.x] = m < C_out ? scale[m] : 0.0f;
    s_bias[threadIdx.x] = bias != nullptr && m < C_out ? static_cast<unsigned>(bias[m]) : 0u;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float inv_y = rcp_approx(y_scale);
  int acc0[NT][4];
  int acc1[NT][4];
  // A full tile: each output channel's codes of this thread's four
  // positions as one word where they lie in one image (N % 4 == 0), else
  // one byte each.
  const auto epilogue = [&]() {
    const int pb = p0 + 32 * warp + 4 * g;
    const bool word_store = (N & 3) == 0;
    const int b0 = pb / N;
    const int n0 = pb - b0 * N;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const int m = blockIdx.y * kCols + col;
        if (m >= C_out) continue;
        const unsigned bm = s_bias[col];
        const float sm = s_scale[col];
        const float v[4] = {dequant(acc0[j][e], bm, sm), dequant(acc0[j][2 + e], bm, sm),
                            dequant(acc1[j][e], bm, sm), dequant(acc1[j][2 + e], bm, sm)};
        float q[4];
        bool all = true;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          q[i] = estimate_q(v[i], inv_y, act);
          all = all && decides(q[i], act);
        }
        if (!all) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (!decides(q[i], act)) q[i] = exact_q(v[i], y_scale, act);
          }
        }
        const unsigned c[4] = {code_of(q[0]), code_of(q[1]), code_of(q[2]), code_of(q[3])};
        if (word_store) {
          *reinterpret_cast<unsigned*>(out + (static_cast<size_t>(b0) * C_out + m) * N + n0) =
              c[0] | (c[1] << 8) | (c[2] << 16) | (c[3] << 24);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int b = (pb + i) / N;
            out[(static_cast<size_t>(b) * C_out + m) * N + (pb + i - b * N)] =
                static_cast<int8_t>(c[i]);
          }
        }
      }
    }
  };
  // The last tile when it is partial (always when N = 1: the batch's
  // images are its positions): the sums of its valid positions go through
  // shared memory (the ring is idle once the last chunk's MMAs are done),
  // so that all four warps, not just the ones holding valid rows, share the
  // requantize; consecutive threads store consecutive channels.
  const auto epilogue_partial = [&]() {
    int* s_acc = reinterpret_cast<int*>(q_smem);  // [kTileP][kCols]
    const int valid = P - p0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const int row = 32 * warp + 4 * g + (e >> 1);  // positions 0, 1 of four
        s_acc[row * kCols + col] = acc0[j][e];
        s_acc[(row + 2) * kCols + col] = acc1[j][e];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < valid * kCols; i += kThreads) {
      const int pos = i / kCols, col = i - pos * kCols;
      const int m = blockIdx.y * kCols + col;
      if (m >= C_out) continue;
      const float v = dequant(s_acc[i], s_bias[col], s_scale[col]);
      float q = estimate_q(v, inv_y, act);
      if (!decides(q, act)) q = exact_q(v, y_scale, act);
      const int p = p0 + pos, b = p / N;
      out[(static_cast<size_t>(b) * C_out + m) * N + (p - b * N)] =
          static_cast<int8_t>(code_of(q));
    }
  };
  // Chunk i: wait for its x (this thread's copies, then everyone's) and
  // its w; once every warp is past chunk i - 2's MMAs, refill that stage
  // with chunk i + kLookahead; build the fragments and issue the MMAs (the
  // first chunk overwrites the accumulators), leaving them in flight while
  // the next chunk's fragments load.
  auto step = [&](int i, unsigned (&a)[2][4]) {
    cp_async_wait<kLookahead - 1>();
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
    __syncthreads();
    load_chunk(i + kLookahead);
    fence_regs(a);
    load_a_s8(a, xring + (i % kStages) * kXStageBytes, warp, g, t, kmajor != 0);
    const uint64_t desc = smem_desc_kmajor(wring + (i % kStages) * kWBytes, 128, 256);
    wgmma_fence();
    WgmmaS8<NT>::run(acc0, a[0], desc, i > 0);
    WgmmaS8<NT>::run(acc1, a[1], desc, i > 0);
    wgmma_commit();
    wgmma_wait<1>();
  };
  unsigned a0[2][4], a1[2][4];
  for (int i = 0; i < kchunks; i += 2) {
    step(i, a0);
    if (i + 1 < kchunks) step(i + 1, a1);
  }
  wgmma_wait<0>();
  fence_regs(acc0);
  fence_regs(acc1);
  fence_regs(a0);
  fence_regs(a1);
  if (p0 + kTileP <= P) {
    epilogue();
  } else {
    epilogue_partial();
  }
}

template <int NT>
int launch_qconv(const void* x, const void* wpack, const void* bias, const void* scale,
                 void* out, int C_in, int C_out, int N, int P, int col_tiles, int piece,
                 bool kmajor, float y_scale, int act, cudaStream_t stream) {
  auto kernel = qconv1x1_requant_kernel<NT>;
  const size_t smem =
      kStages * (kXStageBytes + static_cast<size_t>(NT) * 8 * kKc) + kStages * sizeof(uint64_t);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + kTileP - 1) / kTileP, col_tiles);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wpack),
      static_cast<const int32_t*>(bias), static_cast<const float*>(scale),
      static_cast<int8_t*>(out), C_in, C_out, N, P, (C_in + kKc - 1) / kKc, piece,
      kmajor ? 1 : 0, y_scale, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, C_in, N] int8, wpack [col_tiles, ceil(C_in/32), cols/8, 2, 8, 16]
// int8 (w [C_out, C_in] zero-padded, see ops/cuda/qconv.py), bias [C_out]
// int32 (or null), scale [C_out] float32, out [B, C_out, N] int8; cols in
// {16, 32, 48, 64}; all contiguous on one card.
extern "C" int bn_qconv1x1_requant(const void* x, const void* wpack, const void* bias,
                                   const void* scale, void* out, int B, int C_in,
                                   int C_out, int N, int cols, int col_tiles, float y_scale,
                                   int act, void* stream) {
  const long long P = static_cast<long long>(B) * N;
  if (P <= 0 || P > 0x7FFFFF00LL) return static_cast<int>(cudaErrorInvalidValue);
  // N == 1: x is [B, C_in], K-major; else channel rows of N positions.
  const bool kmajor = N == 1;
  const int run = kmajor ? C_in : N;
  const uintptr_t at = reinterpret_cast<uintptr_t>(x);
  const int piece = run % 16 == 0 && at % 16 == 0 ? 16 : (run % 4 == 0 && at % 4 == 0 ? 4 : 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p = static_cast<int>(P);
  switch (cols) {
    case 16: return launch_qconv<2>(x, wpack, bias, scale, out, C_in, C_out, N, p, col_tiles, piece, kmajor, y_scale, act, s);
    case 32: return launch_qconv<4>(x, wpack, bias, scale, out, C_in, C_out, N, p, col_tiles, piece, kmajor, y_scale, act, s);
    case 48: return launch_qconv<6>(x, wpack, bias, scale, out, C_in, C_out, N, p, col_tiles, piece, kmajor, y_scale, act, s);
    case 64: return launch_qconv<8>(x, wpack, bias, scale, out, C_in, C_out, N, p, col_tiles, piece, kmajor, y_scale, act, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
