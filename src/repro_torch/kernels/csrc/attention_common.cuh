// Shared pieces of the two attention kernels (flash_attention.cu,
// decode_attention.cu): dtype conversion, warp reductions, 16-byte
// cp.async tile copies into shared memory, and f32 dot products of a
// query row against a staged key row with independent partial sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace repro_attn {

// A kernel over 48 KB of dynamic shared memory must say so, once per device
// (the attribute call costs microseconds of host time; per launch it
// showed in the back-to-back time of short prefills).
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static std::atomic<unsigned long long> done{0};  // bit d: set on device d
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

constexpr float NEG_INF = -0.7f * FLT_MAX;   // finite mask sentinel (ref.NEG_INF)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---- 16-byte asynchronous copies (cp.async, sm_80+) ------------------------

// Copy 16 bytes global -> shared without staging in registers; with
// `ok` false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [r0, r0 + ROWS) of a row-strided tensor (row r at src + r *
// stride, HD elements each) into shared rows of LD elements, one 16-byte
// cp.async a piece, spread over NT threads. Rows >= n are zero-filled, so
// a product of a zero probability with them is 0, never NaN.
template <typename T, int HD, int LD, int ROWS, int NT>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, size_t stride,
                                           int r0, int n) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CPR = HD / E;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * E;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * LD + c, ok ? src + (size_t)(r0 + r) * stride + c : src, ok);
  }
}

// ---- f32 math on staged rows ----------------------------------------------

// Four consecutive elements of a shared row as f32 (8-byte aligned for bf16,
// 16-byte aligned for f32).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void fma4(float4& acc, float4 a, float4 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
  acc.z = fmaf(a.z, b.z, acc.z);
  acc.w = fmaf(a.w, b.w, acc.w);
}

__device__ __forceinline__ void axpy4(float4& acc, float p, float4 x) {
  acc.x = fmaf(p, x.x, acc.x);
  acc.y = fmaf(p, x.y, acc.y);
  acc.z = fmaf(p, x.z, acc.z);
  acc.w = fmaf(p, x.w, acc.w);
}

// dot(q, k) over HD: q an f32 shared row, k a staged key row. Four (f32) or
// eight (bf16: one 16-byte load a step) independent partial sums, so the
// HD-long chain becomes HD/4 or HD/8 steps deep.
template <int HD>
__device__ __forceinline__ float dot_row(const float* __restrict__ q, const float* __restrict__ k) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int d = 0; d < HD; d += 4) fma4(a, load4(q + d), load4(k + d));
  return (a.x + a.y) + (a.z + a.w);
}
template <int HD>
__device__ __forceinline__ float dot_row(const float* __restrict__ q,
                                         const __nv_bfloat16* __restrict__ k) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
#pragma unroll
  for (int d = 0; d < HD; d += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(k + d);
    const float2 k0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 k1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    const float2 k2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.z));
    const float2 k3 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.w));
    fma4(a, load4(q + d), make_float4(k0.x, k0.y, k1.x, k1.y));
    fma4(b, load4(q + d + 4), make_float4(k2.x, k2.y, k3.x, k3.y));
  }
  return ((a.x + b.x) + (a.y + b.y)) + ((a.z + b.z) + (a.w + b.w));
}

}  // namespace repro_attn
