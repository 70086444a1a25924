// Flash-decode: one query token per (batch row, head) against the KV cache.
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention_pallas
// (body _decode_kernel). Same function: q (B, H, hd), cache k/v
// (B, M, KV, hd); cache positions < cache_len are valid (the query sits at
// cache_len - 1); an optional window keeps positions >= cache_len - window;
// the G = H / KV query heads of one kv head share its cache stream; finite
// NEG_INF and a denominator clamped at 1e-37. cache_len is (B,) here (the
// wrapper broadcasts a scalar), like ref.decode_attention.
//
// Bound on the H100: the cache bytes (B * M * KV * hd * 2 tensors) over
// HBM, and at the main path's small caches (M <= ~310) launch latency.
// Design: one CTA per (kv head, batch row), 4 warps; the cache is streamed
// once through shared memory in 32-key tiles, each warp owns up to 4 of
// the G query heads, tiles outside [cache_len - window, cache_len) are
// never loaded, and the arithmetic is plain f32 FMA.
//
// cache_len = 0 (an empty cache) gives zeros: no tile is loaded and the
// output is 0 / max(0, 1e-37). This follows decode_attention_pallas, which
// skips every block there; the JAX oracle ref.decode_attention (and the
// plain version) instead averages all M rows, a disagreement inside the
// reference. The serving path never decodes against an empty cache.
#include "attention_common.cuh"

using namespace repro_attn;

namespace {

constexpr int WARPS = 4;
constexpr int MAX_G = 16;
constexpr int RPW = MAX_G / WARPS;

template <typename T, int HD>
__global__ void __launch_bounds__(WARPS * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ out, const int* __restrict__ cache_len, int M, int H, int KV,
              int window, float scale) {
  __shared__ float Qs[MAX_G][HD];
  __shared__ float Ks[BK][HD + 1];
  __shared__ float Vs[BK][HD];
  constexpr int DPL = HD / 32;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cl = cache_len[b];

  for (int idx = threadIdx.x; idx < G * HD; idx += blockDim.x) {
    const int g = idx / HD, d = idx % HD;
    Qs[g][d] = to_f32(q[((size_t)b * H + kvh * G + g) * HD + d]) * scale;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const int lo = window > 0 ? max(0, cl - window) : 0;
  const int hi = min(M, cl);
  for (int k0 = lo / BK * BK; k0 < hi; k0 += BK) {
    __syncthreads();
    load_kv_tile<T, HD>(k, v, Ks, Vs, b, kvh, k0, M, KV);
    __syncthreads();
    const int key = k0 + lane;
    const bool valid = key < cl && key >= lo;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int g = warp + WARPS * r;
      if (g >= G) continue;  // warp-uniform
      attend_tile<HD>(Qs[g], Ks, Vs, key < M, valid, m[r], l[r], acc[r]);
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int g = warp + WARPS * r;
    if (g >= G) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-37f);
    T* o = out + ((size_t)b * H + kvh * G + g) * HD;
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[lane + 32 * i] = from_f32<T>(acc[r][i] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, const int* cache_len,
                   int B, int M, int H, int KV, int hd, int window, float scale,
                   cudaStream_t stream) {
  if (H / KV > MAX_G) return cudaErrorInvalidValue;
  dim3 grid(KV, B);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  switch (hd) {
    case 32: decode_kernel<T, 32><<<grid, WARPS * 32, 0, stream>>>(qq, kk, vv, oo, cache_len, M, H, KV, window, scale); break;
    case 64: decode_kernel<T, 64><<<grid, WARPS * 32, 0, stream>>>(qq, kk, vv, oo, cache_len, M, H, KV, window, scale); break;
    case 128: decode_kernel<T, 128><<<grid, WARPS * 32, 0, stream>>>(qq, kk, vv, oo, cache_len, M, H, KV, window, scale); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. cache_len is (B,) int32 on the device.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                    const int* cache_len, int B, int M, int H, int KV, int hd,
                                    int window, float scale, int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(q, k, v, out, cache_len, B, M, H, KV, hd, window, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, cache_len, B, M, H, KV, hd, window, scale, stream);
  return cudaErrorInvalidValue;
}
