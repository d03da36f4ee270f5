// Pieces that every GUST SpMV source shares: the value load (with the int8
// dequant), the cp.async copies and shared-memory opt-in of the
// double-buffered and segment-local kernels and the mapping from the
// wrappers' dtype codes to kernel types.
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
