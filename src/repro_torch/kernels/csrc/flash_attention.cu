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
// Bound on the H100: at the main path's shapes (Sq <= ~300) the whole call
// is under 1 GFLOP and a few MB, so neither HBM nor the tensor-core peak
// bounds it but latency: the serial chain of key tiles in the CTA of the
// last query rows (five 64-key tiles at Sq=300), each tile's copies, MMAs,
// mask and softmax in turn. The bf16 path uses `mma.sync`; `wgmma` would
// shorten the MMA share of each step (P V and S are ~2.4 and ~2.2 of ~19 us
// at Sq=300, scripts/attention_sweep.py), splitting the chain over CTAs
// the rest: both later steps.
//
// Mask rules, both paths: tiles that the causal/window masks (or kv_len,
// when it is > 0) empty for every row of the CTA are never loaded; inside a
// loaded tile a masked key scores NEG_INF and a key past Sk scores -inf
// (contributes exactly 0). A row whose keys are all masked therefore
// averages the V rows of the tiles its CTA did not skip (kv_len = 0 skips
// nothing, so it averages every key the causal/window masks keep).
//
// bf16 path (llama3-8b, hd 128): a CTA of 4 warps owns 64 query rows of one
// (batch row, head), 16 rows a warp. K/V tiles of 64 keys are staged in
// shared memory with 16-byte cp.async copies in a ring of two stages, so
// the next tile loads while this one computes; a tile that every row of a
// warp sees whole skips the per-element mask. S = Q K^T and O += P V run
// on the tensor cores (mma.sync.m16n8k16, bf16 in, f32 accumulate) with
// operands from shared memory through ldmatrix (V through ldmatrix.trans),
// ordered so that no MMA waits on the one before it; m, l and the rescale
// stay in f32 registers (base-2 exponentials), and P is rounded to bf16
// only as the A operand of P V, where it enters as two bf16 terms (hi and
// the remainder lo) so that P V keeps about 16 bits of P.
//
// f32 path (the RAR tiers and the embedder, hd 32): no tensor cores and no
// TF32 (card == CPU greedy tokens rest on IEEE f32). A CTA of 4 warps owns
// 16 query rows, a warp a row at a time with a lane per key; 32-key K/V
// tiles come in through the same double-buffered cp.async ring; the score
// is four independent partial sums of float4 FMAs, and P V is four
// independent chains over the keys of the tile.
#include "attention_common.cuh"

using namespace repro_attn;

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 64;
constexpr int TC_BK = 64;      // keys a tile
constexpr int TC_STAGES = 2;   // tiles in the copy ring
constexpr int TC_NT = 128;     // 4 warps

template <int HD>
struct TcLayout {
  static constexpr int LD = HD + 8;          // 16-byte pad: ldmatrix rows hit distinct banks
  static constexpr int Q = TC_BQ * LD;       // elements
  static constexpr int KV = TC_BK * LD;      // one K or V tile
  static constexpr size_t BYTES = (size_t)(Q + 2 * TC_STAGES * KV) * sizeof(bf16);
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate. Not
// volatile: a pure register op, free to be scheduled between its neighbours.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) -> a bf16 pair `hi` (x0 in the low half, the lower k index) and
// the pair of what it leaves over, `lo`: hi + lo carries x to ~16 bits.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// First and one-past-last key tile a CTA of query rows [q0, q0 + BQ) needs.
template <int BQ, int BK>
__device__ __forceinline__ void tile_range(int q0, int Sq, int Sk, int causal, int window,
                                           int klen_mask, int& t0, int& t1) {
  const int off = Sk - Sq;
  const int qpos_min = q0 + off;
  const int qpos_max = min(q0 + BQ, Sq) - 1 + off;
  int k_end = causal ? min(Sk, qpos_max + 1) : Sk;
  if (klen_mask > 0) k_end = min(k_end, klen_mask);
  t0 = window > 0 ? max(0, qpos_min - window + 1) / BK : 0;
  t1 = k_end > 0 ? (k_end + BK - 1) / BK : 0;
}

template <int HD>
__global__ void __launch_bounds__(TC_NT)
flash_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out,
                  const int* __restrict__ kv_len, int Sq, int Sk, int H, int KV, int causal,
                  int window, float scale) {
  using L = TcLayout<HD>;
  constexpr int LD = L::LD;
  constexpr int NS = TC_BK / 8;  // key n-tiles of S
  constexpr int NO = HD / 8;     // dim n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KVs = Qs + L::Q;  // stage s: K at KVs + 2 s KV, V right after

  const int q0 = blockIdx.x * TC_BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int off = Sk - Sq;
  const int klen = kv_len ? kv_len[b] : Sk;
  const float scale_log2 = scale * 1.44269504088896341f;  // log2(e)
  int t0, t1;
  tile_range<TC_BQ, TC_BK>(q0, Sq, Sk, causal, window, kv_len ? klen : 0, t0, t1);

  const size_t kv_stride = (size_t)KV * HD;
  const bf16* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const bf16* vb = v + ((size_t)b * Sk * KV + kvh) * HD;
  auto stage = [&](int t) {  // K/V tile t into its stage of the ring
    bf16* dst = KVs + ((t - t0) % TC_STAGES) * 2 * L::KV;
    stage_rows<bf16, HD, LD, TC_BK, TC_NT>(dst, kb, kv_stride, t * TC_BK, Sk);
    stage_rows<bf16, HD, LD, TC_BK, TC_NT>(dst + L::KV, vb, kv_stride, t * TC_BK, Sk);
  };
  if (t0 < t1)  // nothing is copied (or waited for) when every tile is skipped
    stage_rows<bf16, HD, LD, TC_BQ, TC_NT>(Qs, q + ((size_t)b * Sq * H + h) * HD,
                                           (size_t)H * HD, q0, Sq);
  for (int i = 0; i < TC_STAGES - 1; ++i) {
    if (t0 + i < t1) stage(t0 + i);
    cp_async_commit();
  }

  float o[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t qf[HD / 16][4];
  const int row_a = q0 + warp * 16 + gid;  // this thread's rows: row_a, row_a + 8

  for (int t = t0; t < t1; ++t) {
    if (t + TC_STAGES - 1 < t1) stage(t + TC_STAGES - 1);
    cp_async_commit();
    cp_async_wait<TC_STAGES - 1>();
    __syncthreads();
    if (t == t0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }
    const bf16* Kt = KVs + ((t - t0) % TC_STAGES) * 2 * L::KV;
    const bf16* Vt = Kt + L::KV;

    // S = Q K^T: K rows are the B operand's columns (no transpose). A k-step's
    // fragments are all loaded first, so consecutive MMAs never wait on
    // each other or on a load.
    float s[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t kf[NS / 2][4];
#pragma unroll
      for (int np = 0; np < NS / 2; ++np)
        ldsm_x4(kf[np], Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        mma16816(s[2 * np], qf[kk], kf[np][0], kf[np][1]);
        mma16816(s[2 * np + 1], qf[kk], kf[np][2], kf[np][3]);
      }
    }

    // scale, mask, online softmax in f32 (a row's 4 owners are one quad),
    // in base 2: scores carry scale * log2(e), so p = exp2(s - m). A tile
    // whose every key is valid for all 16 rows of the warp skips the mask.
    const int k0 = t * TC_BK;
    const int pw = q0 + warp * 16 + off;  // the warp's first query position
    const bool whole = (!causal || k0 + TC_BK - 1 <= pw) &&
                       (window <= 0 || pw + 15 - k0 < window) && k0 + TC_BK <= klen &&
                       k0 + TC_BK <= Sk;  // warp-uniform
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (!whole) {
          const int key = k0 + nt * 8 + 2 * tig + (e & 1);
          const int diff = row_a + (e >> 1) * 8 + off - key;
          const bool valid =
              (!causal || diff >= 0) && (window <= 0 || diff < window) && key < klen;
          x = key < Sk ? (valid ? x : NEG_INF) : -INFINITY;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        ls[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + ls[i];  // quad-partial; summed at the end
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      o[nt][0] *= corr[0];
      o[nt][1] *= corr[0];
      o[nt][2] *= corr[1];
      o[nt][3] *= corr[1];
    }

    // O += P V: two S n-tiles are one A fragment, P = hi + lo in two bf16
    // terms (P to ~16 bits: one bf16 term alone puts ~4e-3 of error on an
    // output at llama3-8b's shapes, a fifth of the bf16 tolerance). A
    // k-step's V fragments (ldmatrix.trans) are loaded first and feed both
    // products; all hi MMAs go before all lo MMAs, so no MMA waits on the
    // one before it.
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
      uint32_t vf[HD / 16][4];
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp)
        ldsm_x4_trans(vf[dp], Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  dp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        mma16816(o[2 * dp], hi, vf[dp][0], vf[dp][1]);
        mma16816(o[2 * dp + 1], hi, vf[dp][2], vf[dp][3]);
      }
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        mma16816(o[2 * dp], lo, vf[dp][0], vf[dp][1]);
        mma16816(o[2 * dp + 1], lo, vf[dp][2], vf[dp][3]);
      }
    }
    __syncthreads();  // this stage is refilled TC_STAGES - 1 tiles on
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-37f);
    bf16* orow = out + ((size_t)(b * Sq + row) * H + h) * HD + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8) =
          __floats2bfloat162_rn(o[nt][2 * i] * inv, o[nt][2 * i + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// f32: FMA
// ---------------------------------------------------------------------------

constexpr int F_BQ = 16;
constexpr int F_BK = 32;  // keys a tile == warp width
constexpr int F_WARPS = 4;
constexpr int F_NT = F_WARPS * 32;
constexpr int F_RPW = F_BQ / F_WARPS;

template <int HD>
struct F32Layout {
  static constexpr int LD = HD + 4;  // 16-byte rows; float4 reads by 8 lanes hit distinct banks
  static constexpr int Q = F_BQ * HD;
  static constexpr int KV = F_BK * LD;
  static constexpr int P = F_WARPS * F_BK;
  static constexpr size_t BYTES = (size_t)(Q + 4 * KV + P) * sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(F_NT)
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 const int* __restrict__ kv_len, int Sq, int Sk, int H, int KV, int causal,
                 int window, float scale) {
  using L = F32Layout<HD>;
  constexpr int LD = L::LD;
  constexpr int DPL = HD / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* KVs = Qs + L::Q;
  float* Ps = KVs + 4 * L::KV;

  const int q0 = blockIdx.x * F_BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int off = Sk - Sq;
  const int klen = kv_len ? kv_len[b] : Sk;
  int t0, t1;
  tile_range<F_BQ, F_BK>(q0, Sq, Sk, causal, window, kv_len ? klen : 0, t0, t1);

  const size_t kv_stride = (size_t)KV * HD;
  const float* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const float* vb = v + ((size_t)b * Sk * KV + kvh) * HD;
  if (t0 < t1) {
    stage_rows<float, HD, LD, F_BK, F_NT>(KVs, kb, kv_stride, t0 * F_BK, Sk);
    stage_rows<float, HD, LD, F_BK, F_NT>(KVs + L::KV, vb, kv_stride, t0 * F_BK, Sk);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < F_BQ * HD / 4; i += F_NT) {
    const int r = i / (HD / 4), d = (i % (HD / 4)) * 4, qi = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < Sq) x = *reinterpret_cast<const float4*>(q + ((size_t)(b * Sq + qi) * H + h) * HD + d);
    store4(Qs + r * HD + d, make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale));
  }

  float m[F_RPW], l[F_RPW], acc[F_RPW][DPL];
#pragma unroll
  for (int r = 0; r < F_RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  float* pw = Ps + warp * F_BK;

  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < t1) {
      float* nk = KVs + (st ^ 1) * 2 * L::KV;
      stage_rows<float, HD, LD, F_BK, F_NT>(nk, kb, kv_stride, (t + 1) * F_BK, Sk);
      stage_rows<float, HD, LD, F_BK, F_NT>(nk + L::KV, vb, kv_stride, (t + 1) * F_BK, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile t landed (and Qs written, the first time)
    const float* Kt = KVs + st * 2 * L::KV;
    const float* Vt = Kt + L::KV;
    const int key = t * F_BK + lane;
#pragma unroll
    for (int r = 0; r < F_RPW; ++r) {
      const int row = warp + F_WARPS * r, qi = q0 + row;
      if (qi >= Sq) continue;  // warp-uniform
      const int diff = qi + off - key;
      const bool valid = (!causal || diff >= 0) && (window <= 0 || diff < window) && key < klen;
      float s = -INFINITY;
      if (key < Sk) s = valid ? dot_row<HD>(Qs + row * HD, Kt + lane * LD) : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float p = expf(s - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
      pw[lane] = p;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const float* vc = Vt + lane + 32 * i;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int j = 0; j < F_BK; j += 4) {
          a0 = fmaf(pw[j], vc[j * LD], a0);
          a1 = fmaf(pw[j + 1], vc[(j + 1) * LD], a1);
          a2 = fmaf(pw[j + 2], vc[(j + 2) * LD], a2);
          a3 = fmaf(pw[j + 3], vc[(j + 3) * LD], a3);
        }
        acc[r][i] = acc[r][i] * corr + ((a0 + a1) + (a2 + a3));
      }
      __syncwarp();  // pw is rewritten by the next row
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < F_RPW; ++r) {
    const int row = warp + F_WARPS * r, qi = q0 + row;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-37f);
    float* o = out + ((size_t)(b * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[lane + 32 * i] = acc[r][i] * inv;
  }
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, const int* kv_len,
                        int B, int Sq, int Sk, int H, int KV, int causal, int window, float scale,
                        cudaStream_t stream) {
  const cudaError_t attr = allow_smem<flash_kernel_bf16<HD>>(TcLayout<HD>::BYTES);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Sq + TC_BQ - 1) / TC_BQ, H, B);
  flash_kernel_bf16<HD><<<grid, TC_NT, TcLayout<HD>::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), kv_len, Sq, Sk, H, KV, causal, window, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, const int* kv_len,
                       int B, int Sq, int Sk, int H, int KV, int causal, int window, float scale,
                       cudaStream_t stream) {
  const cudaError_t attr = allow_smem<flash_kernel_f32<HD>>(F32Layout<HD>::BYTES);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Sq + F_BQ - 1) / F_BQ, H, B);
  flash_kernel_f32<HD><<<grid, F_NT, F32Layout<HD>::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), kv_len, Sq, Sk, H, KV, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_len may be null (every key exists).
// q, k, v and out are contiguous and 16-byte aligned.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   const int* kv_len, int B, int Sq, int Sk, int H, int KV,
                                   int hd, int causal, int window, float scale, int dtype,
                                   cudaStream_t stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV) return cudaErrorInvalidValue;
#define REPRO_FLASH(HD)                                                                        \
  case HD:                                                                                     \
    return dtype == 0 ? launch_f32<HD>(q, k, v, out, kv_len, B, Sq, Sk, H, KV, causal, window, \
                                       scale, stream)                                          \
                      : launch_bf16<HD>(q, k, v, out, kv_len, B, Sq, Sk, H, KV, causal,        \
                                        window, scale, stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (hd) {
    REPRO_FLASH(32)
    REPRO_FLASH(64)
    REPRO_FLASH(128)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH
}
