// Hopper (sm_90a) building blocks shared by the fused-Hessian kernels of
// hess_kernels.cu (B4, B6) and hess_v3_kernels.cu (B5): shared-memory
// addresses, mbarriers, wgmma descriptors for the canonical K-major layout
// without swizzle, and the products of a bf16 split.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ inline int64_t cdiv(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
// A wait of more than 2^35 cycles (~19 s) traps: a lost arrival then ends
// the launch with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 35)) asm volatile("trap;\n");
  } while (!done);
}

// A wgmma shared-memory descriptor: start address, leading (K) and stride
// (M/N) byte offsets, no swizzle.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, int lbo,
                                               int sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// The split's products e < n_products(P), pieces (prod_a(e), prod_b(e)):
// hi = 0, then lo = 1 (P = 2) or mid = 1, lo = 2 (P = 3).  P = 2: hh, hl,
// lh; P = 3 adds hl, lh of the lo piece and mm.
__host__ __device__ constexpr int n_products(int P) { return P == 2 ? 3 : 6; }
__device__ __forceinline__ int prod_a(int e) {
  return (e == 2 || e == 5) ? 1 : (e == 4 ? 2 : 0);
}
__device__ __forceinline__ int prod_b(int e) {
  return (e == 1 || e == 5) ? 1 : (e == 3 ? 2 : 0);
}

}  // namespace
