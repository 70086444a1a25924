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
// Ring mode (the ring KV cache of src/repro/models/model.py, a separate
// instantiation; the prefix read above is unchanged): the cache holds the
// last M positions, position p in slot p % M, so slot i holds absolute
// position cache_len - 1 - ((cache_len - 1 - i) mod M), masked where that
// is negative (not yet written). The valid positions are
// [max(0, cache_len - min(window or M, M)), cache_len): the chunks tile
// those absolute positions as they tile a prefix, and each key row is
// loaded from slot p % M. The range is at most M long, so it wraps at most
// once and no chunk reads a slot twice.
//
// Bound on the H100: the valid cache bytes over HBM (at llama3-8b B=1,
// cache 4096: 16.8 MB, 5 us), and at the main path's small caches (a few
// hundred keys, ~1.2 MB a layer) the latency of one launch. A CTA per
// (kv head, batch row) streams its cache alone: at B=1 that is 8 CTAs on
// 132 SMs, each waiting on its own loads one tile after another.
//
// Design: split-KV. The valid key range [lo, hi) of each (batch row, kv
// head) -- hi = min(M, cache_len), lo = max(0, cache_len - window) with a
// window, else 0 -- is cut into chunks of `chunk` keys (the wrapper picks
// the chunk so that B * KV * n_chunks fills the card, with no chunk under
// one 32-key tile); one CTA of 4 warps per (chunk, kv head, batch row), and
// a CTA past its row's own range exits at once. Inside a chunk, K/V tiles
// of 32 keys come in as 16-byte cp.async copies in a ring of two stages,
// the next tile in flight while this one computes (four stages, and copies
// issued before cache_len is read, measured no faster: PERF.md); all G
// query heads of the kv group are served from that one pass (a warp
// per head for the scores, a lane per key; all threads for P V, unrolled
// over the tile). The arithmetic is f32 FMA: decode reads far more bytes
// than it has operations for them, so tensor cores buy nothing.
//
// Head widths 32, 64, 96, 128 and 256 (phi-3-vision's 96, recurrentgemma-2b's
// 256 with G = 10 query heads over one kv head): every split of a row is in
// 4- or 8-element pieces, and the f32 ring at 256 takes 148 KB of shared
// memory, opted in per device.
//
// Combine, in the same launch: each chunk writes its partial (m, l,
// acc[hd]) in f32 to a workspace; the last CTA of a (kv head, batch row) to
// take a ticket merges them, each weighted by exp(m_chunk - m_max), and
// resets the ticket to 0 for the next launch. The merge loads every (m, l)
// in one round and keeps eight partial rows in flight a thread (a loop of
// dependent L2 reads, one a chunk, would cost more than the chunks save). A
// row whose range fits one chunk writes its output directly. Every key of
// a chunk is valid (chunks tile [lo, hi) exactly), so no mask enters the
// scores.
//
// cache_len = 0 (an empty cache) gives zeros: no chunk has a key and the
// first CTA writes 0. This follows decode_attention_pallas, which skips
// every block there; the JAX oracle ref.decode_attention (and the plain
// version) instead averages all M rows, a disagreement inside the
// reference. The serving path never decodes against an empty cache.
#include "attention_common.cuh"

using namespace repro_attn;

namespace {

constexpr int WARPS = 4;
constexpr int NT = WARPS * 32;
constexpr int MAX_G = 16;
constexpr int MAX_CHUNKS = 64;  // chunks a row at most (the wrapper's split caps it)
constexpr int TK = 32;          // keys a tile == warp width
constexpr int STAGES = 2;       // tiles in the copy ring (four were no faster)

template <typename T, int HD>
struct DecodeLayout {
  static constexpr int LD = HD + 16 / sizeof(T);  // 16-byte pad: lanes' rows on distinct banks
  static constexpr int RV = (MAX_G * HD / 4 + NT - 1) / NT;  // output float4s a thread
  static constexpr int QV = (MAX_G * HD + NT - 1) / NT;      // query elements a thread
  static constexpr int TILE = TK * LD;                        // elements of one K or V tile
  static constexpr size_t RING = (size_t)STAGES * 2 * TILE * sizeof(T);
  static constexpr size_t BYTES = RING + (size_t)MAX_G * (HD + TK) * sizeof(float);
  static_assert(RING >= 2 * MAX_CHUNKS * MAX_G * sizeof(float),
                "the merge's (m, l) table lives in the tile ring");
};

// Rows [r0, r0 + ROWS) of a ring of M slots (position p in slot p % M)
// into shared rows, as stage_rows; rows >= n are zero-filled. n - r0 <= M,
// so a row's slot is (r0 mod M) + r less M at most once.
template <typename T, int HD, int LD, int ROWS, int NT>
__device__ __forceinline__ void stage_ring_rows(T* dst, const T* __restrict__ src, size_t stride,
                                                int r0, int n, int M) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CPR = HD / E;
  const int base = r0 % M;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * E;
    const bool ok = r0 + r < n;
    const int slot = base + r >= M ? base + r - M : base + r;
    cp_async16(dst + r * LD + c, ok ? src + (size_t)slot * stride + c : src, ok);
  }
}

template <typename T, int HD, bool RING>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ out, const int* __restrict__ cache_len, int M, int H, int KV,
              int window, float scale, int chunk, float* __restrict__ ws_acc,
              float* __restrict__ ws_ml, unsigned int* __restrict__ tickets) {
  using L = DecodeLayout<T, HD>;
  constexpr int LD = L::LD, RV = L::RV, QV = L::QV, V4 = HD / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);  // stage s: K at 2s, V at 2s + 1 tiles
  float* const Qs = reinterpret_cast<float*>(smem_raw + L::RING);  // [MAX_G][HD]
  float* const Ps = Qs + MAX_G * HD;                                // [MAX_G][TK]
  __shared__ float corr_s[MAX_G], l_s[MAX_G];
  __shared__ bool last;

  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int NC = gridDim.x;
  const int G = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t kv_stride = (size_t)KV * HD;
  const T* kb = k + ((size_t)b * M * KV + kvh) * HD;
  const T* vb = v + ((size_t)b * M * KV + kvh) * HD;
  auto stage = [&](int t, int r0, int n) {  // tile t (rows r0.., < n) into its stage
    T* dst = ring + (t % STAGES) * 2 * L::TILE;
    if constexpr (RING) {
      stage_ring_rows<T, HD, LD, TK, NT>(dst, kb, kv_stride, r0, n, M);
      stage_ring_rows<T, HD, LD, TK, NT>(dst + L::TILE, vb, kv_stride, r0, n, M);
    } else {
      stage_rows<T, HD, LD, TK, NT>(dst, kb, kv_stride, r0, n);
      stage_rows<T, HD, LD, TK, NT>(dst + L::TILE, vb, kv_stride, r0, n);
    }
  };

  const T* qg = q + ((size_t)b * H + kvh * G) * HD;  // the group's G x HD queries
  float qv[QV];
#pragma unroll
  for (int r = 0; r < QV; ++r) {
    const int i = threadIdx.x + r * NT;
    qv[r] = i < G * HD ? to_f32(qg[i]) : 0.f;  // all loads in flight at once
  }
#pragma unroll
  for (int r = 0; r < QV; ++r) {
    const int i = threadIdx.x + r * NT;
    if (i < G * HD) Qs[i] = qv[r] * scale;
  }

  const int cl = cache_len[b];
  // the valid positions [lo, hi): a prefix of the slots, or in a ring the
  // last min(window or M, M) positions
  const int hi = RING ? cl : min(M, cl);
  const int lo = RING ? max(0, cl - (window > 0 ? min(window, M) : M))
                      : (window > 0 ? max(0, cl - window) : 0);
  const int nv = hi > lo ? (hi - lo + chunk - 1) / chunk : 0;  // chunks holding keys
  T* o = out + ((size_t)b * H + kvh * G) * HD;                  // the group's G x HD outputs
  if (c >= nv) {
    if (c == 0)
      for (int i = threadIdx.x; i < G * HD; i += NT) o[i] = from_f32<T>(0.f);
    return;
  }

  const int c0 = lo + c * chunk, c1 = min(hi, c0 + chunk);
  const int ntile = (c1 - c0 + TK - 1) / TK;
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntile) stage(t, c0 + t * TK, c1);
    cp_async_commit();
  }

  float m_r[MAX_G / WARPS], l_r[MAX_G / WARPS];
#pragma unroll
  for (int r = 0; r < MAX_G / WARPS; ++r) {
    m_r[r] = -INFINITY;
    l_r[r] = 0.f;
  }
  float4 acc[RV];
#pragma unroll
  for (int r = 0; r < RV; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < ntile; ++t) {
    if (t + STAGES - 1 < ntile) stage(t + STAGES - 1, c0 + (t + STAGES - 1) * TK, c1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();  // tile t landed (and Qs written, the first time)
    const int cnt = min(TK, c1 - (c0 + t * TK));
    const T* Kt = ring + (t % STAGES) * 2 * L::TILE;
    const T* Vt = Kt + L::TILE;

    // scores and the online-softmax step: a warp per head, a lane per key
#pragma unroll
    for (int r = 0; r < MAX_G / WARPS; ++r) {
      const int g = warp + WARPS * r;
      if (g >= G) break;  // warp-uniform
      const float s = lane < cnt ? dot_row<HD>(Qs + g * HD, Kt + lane * LD) : -INFINITY;
      const float m_new = fmaxf(m_r[r], warp_max(s));  // finite: cnt >= 1
      const float p = expf(s - m_new);                 // 0 past cnt
      const float corr = expf(m_r[r] - m_new);
      l_r[r] = l_r[r] * corr + warp_sum(p);
      m_r[r] = m_new;
      Ps[g * TK + lane] = p;
      if (lane == 0) corr_s[g] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P V over the whole tile: p is 0 past cnt, where
    // the rows were zero-filled
#pragma unroll
    for (int r = 0; r < RV; ++r) {
      const int i = threadIdx.x + r * NT;
      if (i < G * V4) {
        const int g = i / V4, d = (i % V4) * 4;
        const float cr = corr_s[g];
        const float* pg = Ps + g * TK;
        float4 a0 = make_float4(acc[r].x * cr, acc[r].y * cr, acc[r].z * cr, acc[r].w * cr);
        float4 a1 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < TK; j += 2) {
          axpy4(a0, pg[j], load4(Vt + j * LD + d));
          axpy4(a1, pg[j + 1], load4(Vt + (j + 1) * LD + d));
        }
        acc[r] = make_float4(a0.x + a1.x, a0.y + a1.y, a0.z + a1.z, a0.w + a1.w);
      }
    }
    __syncthreads();  // this stage is refilled STAGES - 1 tiles on; Ps/corr_s rewritten
  }

#pragma unroll
  for (int r = 0; r < MAX_G / WARPS; ++r) {
    const int g = warp + WARPS * r;
    if (g < G && lane == 0) {
      corr_s[g] = m_r[r];  // this chunk's m
      l_s[g] = l_r[r];
    }
  }
  __syncthreads();

  if (nv == 1) {  // the row's whole range in this chunk: no combine
#pragma unroll
    for (int r = 0; r < RV; ++r) {
      const int i = threadIdx.x + r * NT;
      if (i < G * V4) {
        const int g = i / V4, d = (i % V4) * 4;
        const float inv = 1.f / fmaxf(l_s[g], 1e-37f);
        store4(o + g * HD + d, make_float4(acc[r].x * inv, acc[r].y * inv, acc[r].z * inv,
                                           acc[r].w * inv));
      }
    }
    return;
  }

  // partial of this chunk -> workspace [B * KV][NC][G] x (acc[HD]; m, l)
  const size_t bk = (size_t)b * KV + kvh;
  float* pa = ws_acc + (bk * NC + c) * G * HD;
  float* pml = ws_ml + (bk * NC + c) * G * 2;
#pragma unroll
  for (int r = 0; r < RV; ++r) {
    const int i = threadIdx.x + r * NT;
    if (i < G * V4) store4(pa + i * 4, acc[r]);
  }
  if (threadIdx.x < G) {
    pml[2 * threadIdx.x] = corr_s[threadIdx.x];
    pml[2 * threadIdx.x + 1] = l_s[threadIdx.x];
  }

  // the last chunk of this (kv head, batch row) to finish merges them all
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + bk, 1u) == (unsigned)(nv - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* wa = ws_acc + bk * NC * G * HD;
  const float* wml = ws_ml + bk * NC * G * 2;
  // (m, l) of every (chunk, head) in one round of loads, into the idle ring
  float* cm = reinterpret_cast<float*>(smem_raw);
  float* cls = cm + MAX_CHUNKS * MAX_G;
  for (int i = threadIdx.x; i < nv * G; i += NT) {
    cm[i] = __ldcg(wml + 2 * i);
    cls[i] = __ldcg(wml + 2 * i + 1);
  }
  __syncthreads();
  // per head (a warp, lanes over chunks): m_max, the weights exp(m - m_max)
  // in place of m, and the merged l
#pragma unroll
  for (int r = 0; r < MAX_G / WARPS; ++r) {
    const int g = warp + WARPS * r;
    if (g >= G) break;  // warp-uniform
    float mx = -INFINITY;
    for (int cc = lane; cc < nv; cc += 32) mx = fmaxf(mx, cm[cc * G + g]);
    mx = warp_max(mx);
    float lsum = 0.f;
    for (int cc = lane; cc < nv; cc += 32) {
      const float w = expf(cm[cc * G + g] - mx);
      cm[cc * G + g] = w;
      lsum = fmaf(w, cls[cc * G + g], lsum);
    }
    lsum = warp_sum(lsum);
    if (lane == 0) l_s[g] = lsum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * V4; i += NT) {
    const int g = i / V4;
    const float* src = wa + 4 * i;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int cc = 0; cc < nv; ++cc)  // independent loads, eight in flight
      axpy4(a, cm[cc * G + g],
            __ldcg(reinterpret_cast<const float4*>(src + (size_t)cc * G * HD)));
    const float inv = 1.f / fmaxf(l_s[g], 1e-37f);
    store4(o + 4 * i, make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
  }
  if (threadIdx.x == 0) tickets[bk] = 0u;  // every chunk has taken its ticket
}

template <typename T, int HD, bool RING>
cudaError_t launch_hd(const T* q, const T* k, const T* v, T* out, const int* cache_len, int B,
                      int M, int H, int KV, int window, float scale, int chunk, int n_chunks,
                      float* ws, float* ws_ml, unsigned int* tickets, cudaStream_t stream) {
  constexpr size_t bytes = DecodeLayout<T, HD>::BYTES;
  const cudaError_t attr = allow_smem<decode_kernel<T, HD, RING>>(bytes);
  if (attr != cudaSuccess) return attr;
  decode_kernel<T, HD, RING><<<dim3(n_chunks, KV, B), NT, bytes, stream>>>(
      q, k, v, out, cache_len, M, H, KV, window, scale, chunk, ws, ws_ml, tickets);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, const int* cache_len,
                   int B, int M, int H, int KV, int hd, int window, int ring, float scale,
                   int chunk, int n_chunks, float* ws, unsigned int* tickets,
                   cudaStream_t stream) {
  if (B < 1 || M < 1 || KV < 1 || H % KV || H / KV > MAX_G || chunk < 1 || n_chunks < 1 ||
      n_chunks > MAX_CHUNKS)
    return cudaErrorInvalidValue;
  if (n_chunks > 1 && (ws == nullptr || tickets == nullptr)) return cudaErrorInvalidValue;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  float* ws_ml = ws ? ws + (size_t)B * KV * n_chunks * (H / KV) * hd : nullptr;
  switch (hd) {
#define REPRO_DECODE(HD)                                                                    \
  case HD:                                                                                  \
    return ring ? launch_hd<T, HD, true>(qq, kk, vv, oo, cache_len, B, M, H, KV, window,    \
                                         scale, chunk, n_chunks, ws, ws_ml, tickets, stream)  \
                : launch_hd<T, HD, false>(qq, kk, vv, oo, cache_len, B, M, H, KV, window,   \
                                          scale, chunk, n_chunks, ws, ws_ml, tickets, stream);
    REPRO_DECODE(32)
    REPRO_DECODE(64)
    REPRO_DECODE(96)
    REPRO_DECODE(128)
    REPRO_DECODE(256)
#undef REPRO_DECODE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. cache_len is (B,) int32 on the device.
// ring: 0 = the cache is a prefix of positions, 1 = a ring of M slots.
// The valid range of each row is cut into chunks of `chunk` keys, n_chunks
// (<= 64) CTAs per (kv head, batch row); n_chunks * chunk must cover
// min(M, window) (M without a window). With n_chunks > 1, ws holds
// B * KV * n_chunks * G * (hd + 2) floats and tickets B * KV zeros (left
// zero after every launch).
// q, k, v and out are contiguous and 16-byte aligned.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                    const int* cache_len, int B, int M, int H, int KV, int hd,
                                    int window, int ring, float scale, int dtype, int chunk,
                                    int n_chunks, float* ws, unsigned int* tickets,
                                    cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(q, k, v, out, cache_len, B, M, H, KV, hd, window, ring, scale, chunk,
                         n_chunks, ws, tickets, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, cache_len, B, M, H, KV, hd, window, ring, scale,
                                 chunk, n_chunks, ws, tickets, stream);
  return cudaErrorInvalidValue;
}
