// Pieces that every GUST SpMV source shares: the value load (with the int8
// dequant), the cp.async copies, the mbarrier and bulk-copy (TMA)
// primitives and shared-memory opt-in of the spread kernels, and the
// mapping from the wrappers' dtype codes to kernel types.
// The bitwise contracts between the sources (single == double, resident ==
// local) rest on both being the same everywhere, so they live only here.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace gust {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

// A stream value as f32; int8 is dequantized as float(q) * scale of its
// pack-time block, rounded once.
template <bool QUANT, typename V>
__device__ __forceinline__ float load_value(V v, float scale) {
  const float f = to_f32(v);
  return QUANT ? __fmul_rn(f, scale) : f;
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarrier and 1-D bulk copy (the Tensor Memory Accelerator without a
// tensor map), as the PTX ISA defines them for sm_90.  A CTA launched
// without a cluster is a cluster of one, so its shared::cta addresses are
// valid shared::cluster destinations.

// Initialise the mbarrier at bar (8-byte aligned, shared) for `count`
// arrivals per phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make this thread's mbarrier inits visible to the async proxy (the bulk
// copies that complete on them); a CTA barrier then publishes them to the
// other threads.
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once on bar and add `bytes` to the transactions its current phase
// waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of bar with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        "  .reg .pred p;\n"
        "  mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "  selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// device memory at src to shared memory at dst, completing as transactions
// on bar.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Order this CTA's earlier generic-proxy accesses of shared memory (made
// visible to this thread by a CTA barrier) before its later async-proxy
// writes there: a stage that threads have read may then be refilled.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The most dynamic shared memory a CTA of the current device may opt in to.
inline int max_shared_bytes() {
  int dev = 0, bytes = 48 * 1024;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return bytes;
}

// Above 48 KB, dynamic shared memory needs the kernel's opt-in, or the
// launch is refused.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
struct Type {
  using type = T;
};

// Call f(Type<V>, Type<I>, std::bool_constant<QUANT>) for the wrappers'
// codes — vdt: 0 float32, 1 bfloat16, 2 int8 (quantized, scale required);
// idt: 0 int32, 1 int16 — and return its result; cudaErrorInvalidValue
// for an unknown code.
template <typename F>
cudaError_t dispatch_dtypes(int vdt, int idt, F&& f) {
  using Q = std::true_type;
  using NQ = std::false_type;
  if (idt == 0) {
    if (vdt == 0) return f(Type<float>{}, Type<int32_t>{}, NQ{});
    if (vdt == 1) return f(Type<__nv_bfloat16>{}, Type<int32_t>{}, NQ{});
    if (vdt == 2) return f(Type<int8_t>{}, Type<int32_t>{}, Q{});
  } else if (idt == 1) {
    if (vdt == 0) return f(Type<float>{}, Type<int16_t>{}, NQ{});
    if (vdt == 1) return f(Type<__nv_bfloat16>{}, Type<int16_t>{}, NQ{});
    if (vdt == 2) return f(Type<int8_t>{}, Type<int16_t>{}, Q{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace gust
