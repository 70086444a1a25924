// Blocked online-softmax (flash) attention for prefill and the embedder.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body _flash_kernel). Same function: q (B, Sq, H, hd) against k/v
// (B, Sk, KV, hd), G = H / KV query heads per kv head, positions aligned to
// the sequence end (query i sits at i + Sk - Sq), optional causal and
// sliding-window masks, finite NEG_INF, denominator clamped at 1e-37, f32
// accumulation for f32 and bf16 inputs. Added over the Pallas kernel: a
// ragged edge on Sq and Sk, and an optional per-row key count kv_len (B,)
// (the embedder's right-padded PAD keys).
//
// Bound on the H100: at the main path's shapes (Sq <= ~300, hd 32 or 128)
// the work is a few MFLOP to a few GFLOP and the inputs a few MB, so launch
// latency and the serial per-tile loop bound it, not HBM or the tensor
// cores. Design: one CTA per (16-query tile, head, batch row), 4 warps, each
// warp owning 4 query rows; K/V are streamed through shared memory in
// 32-key tiles (read once per CTA, shared by its 16 rows), tiles that the
// causal/window masks empty for every row of the CTA are skipped, and all
// arithmetic is plain f32 FMA (no tensor cores yet: a later PR's work).
#include "attention_common.cuh"

using namespace repro_attn;

namespace {

constexpr int BQ = 16;
constexpr int WARPS = 4;
constexpr int RPW = BQ / WARPS;  // query rows per warp

template <typename T, int HD>
__global__ void __launch_bounds__(WARPS * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, const int* __restrict__ kv_len, int Sq, int Sk, int H, int KV,
             int causal, int window, float scale) {
  __shared__ float Qs[BQ][HD];
  __shared__ float Ks[BK][HD + 1];
  __shared__ float Vs[BK][HD];
  constexpr int DPL = HD / 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int off = Sk - Sq;
  const int klen = kv_len ? kv_len[b] : Sk;

  for (int idx = threadIdx.x; idx < BQ * HD; idx += blockDim.x) {
    const int r = idx / HD, d = idx % HD, qi = q0 + r;
    Qs[r][d] = qi < Sq ? to_f32(q[((size_t)(b * Sq + qi) * H + h) * HD + d]) * scale : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const int qpos_min = q0 + off;
  const int qpos_max = min(q0 + BQ, Sq) - 1 + off;
  const int k_end = causal ? min(Sk, qpos_max + 1) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    if (window > 0 && qpos_min - (k0 + BK - 1) >= window) continue;  // whole tile out of window
    __syncthreads();  // previous tile fully consumed (and Qs written, first time)
    load_kv_tile<T, HD>(k, v, Ks, Vs, b, kvh, k0, Sk, KV);
    __syncthreads();
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp + WARPS * r, qi = q0 + row;
      if (qi >= Sq) continue;  // warp-uniform
      const int diff = qi + off - key;
      const bool valid = (!causal || diff >= 0) && (window <= 0 || diff < window) && key < klen;
      attend_tile<HD>(Qs[row], Ks, Vs, key < Sk, valid, m[r], l[r], acc[r]);
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = warp + WARPS * r, qi = q0 + row;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-37f);
    T* o = out + ((size_t)(b * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[lane + 32 * i] = from_f32<T>(acc[r][i] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, const int* kv_len,
                   int B, int Sq, int Sk, int H, int KV, int hd, int causal, int window,
                   float scale, cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  switch (hd) {
    case 32: flash_kernel<T, 32><<<grid, WARPS * 32, 0, stream>>>(qq, kk, vv, oo, kv_len, Sq, Sk, H, KV, causal, window, scale); break;
    case 64: flash_kernel<T, 64><<<grid, WARPS * 32, 0, stream>>>(qq, kk, vv, oo, kv_len, Sq, Sk, H, KV, causal, window, scale); break;
    case 128: flash_kernel<T, 128><<<grid, WARPS * 32, 0, stream>>>(qq, kk, vv, oo, kv_len, Sq, Sk, H, KV, causal, window, scale); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_len may be null (every key exists).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   const int* kv_len, int B, int Sq, int Sk, int H, int KV,
                                   int hd, int causal, int window, float scale, int dtype,
                                   cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(q, k, v, out, kv_len, B, Sq, Sk, H, KV, hd, causal, window, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, kv_len, B, Sq, Sk, H, KV, hd, causal, window, scale, stream);
  return cudaErrorInvalidValue;
}
