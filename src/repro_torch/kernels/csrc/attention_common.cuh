// Shared pieces of the two attention kernels (flash_attention.cu,
// decode_attention.cu): dtype conversion, warp reductions and the
// online-softmax update of one query row against one 32-key tile.
//
// Layout of the per-row state: a warp owns a query row; lane `l` keeps the
// output dims d = l + 32*i (i < DPL, DPL = head_dim / 32) of the f32
// accumulator, so V-tile reads are one coalesced 32-float line per key.
// For the scores each lane takes one key of the tile (BK == 32) and dots
// the whole head_dim against the query row held in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace repro_attn {

constexpr int BK = 32;                       // keys per tile == warp width
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

// Load one (BK, HD) tile of K and V rows [k0, k0 + BK) for kv head `kvh`
// of batch row `b` into shared memory as f32. Rows past `n_keys` are
// zero-filled: their probability is exactly 0, and 0 * garbage could be NaN.
template <typename T, int HD>
__device__ __forceinline__ void load_kv_tile(const T* __restrict__ k, const T* __restrict__ v,
                                             float (*Ks)[HD + 1], float (*Vs)[HD],
                                             int b, int kvh, int k0, int n_keys, int KV) {
  for (int idx = threadIdx.x; idx < BK * HD; idx += blockDim.x) {
    const int j = idx / HD, d = idx % HD, key = k0 + j;
    float kx = 0.f, vx = 0.f;
    if (key < n_keys) {
      const size_t off = ((size_t)(b * n_keys + key) * KV + kvh) * HD + d;
      kx = to_f32(k[off]);
      vx = to_f32(v[off]);
    }
    Ks[j][d] = kx;
    Vs[j][d] = vx;
  }
}

// One online-softmax step of a query row (q in shared memory, already
// scaled) over the tile in Ks/Vs. `state` says per key what it is:
//   valid  -> its dot product;
//   masked -> NEG_INF (exp underflows to 0 once a valid key was seen; a
//             first all-masked tile's p = 1 garbage is wiped by the later
//             corr = exp(NEG_INF - m) = 0, which -inf would turn into NaN);
//   absent (past the key count) -> -inf, contributing exactly 0.
template <int HD>
__device__ __forceinline__ void attend_tile(const float* __restrict__ qrow, float (*Ks)[HD + 1],
                                            float (*Vs)[HD], bool exists, bool valid, float& m,
                                            float& l, float (&acc)[HD / 32]) {
  constexpr int DPL = HD / 32;
  const int lane = threadIdx.x & 31;
  float s = -INFINITY;
  if (exists) {
    float dot = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) dot = fmaf(qrow[d], Ks[lane][d], dot);
    s = valid ? dot : NEG_INF;
  }
  const float m_new = fmaxf(m, warp_max(s));
  const float p = expf(s - m_new);
  const float corr = expf(m - m_new);
  l = l * corr + warp_sum(p);
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    float a = 0.f;
#pragma unroll 8
    for (int j = 0; j < BK; ++j) a = fmaf(__shfl_sync(0xffffffffu, p, j), Vs[j][lane + 32 * i], a);
    acc[i] = acc[i] * corr + a;
  }
  m = m_new;
}

}  // namespace repro_attn
