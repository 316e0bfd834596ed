// Hopper (sm_90a) primitives shared by the tensor-core kernels of
// frontend.cu and qconv.cu: cp.async staging, the TMA bulk copies and their
// mbarriers, wgmma's fences and shared-memory descriptors.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// The shared memory a block may use on an H100 (232,448 bytes).
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; the bytes past src_bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

// 4-byte global -> shared copy; zero-filled when src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most kPending of this thread's cp.async groups are pending.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma reads (A) or accumulates into (D) across the fences.
template <int NT>
__device__ __forceinline__ void fence_regs(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
  }
}

template <int NK>
__device__ __forceinline__ void fence_regs(unsigned (&a)[NK][4]) {
#pragma unroll
  for (int j = 0; j < NK; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
  }
}

template <int NT>
__device__ __forceinline__ void fence_regs(int (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[j][e])::"memory");
  }
}

// The shared-memory descriptor of a K-major, unswizzled B tile starting at
// p, made of core matrices of 8 rows x 16 bytes (128 contiguous bytes): the
// start address, then the byte offsets (over 16) between core matrices
// along K (lbo, the leading dimension) and along N (sbo, the stride
// dimension).
__device__ __forceinline__ uint64_t smem_desc_kmajor(const void* p, unsigned lbo,
                                                     unsigned sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// A B ring's chunks arrive by bulk copy (the TMA), each completing on its
// stage's mbarrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread copies bytes (a multiple of 16) from the 16-byte-aligned src
// to dst; the copy completes the current phase of bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait until the phase of bar with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Allow a kernel more than 48 KB of dynamic shared memory where it needs it.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
