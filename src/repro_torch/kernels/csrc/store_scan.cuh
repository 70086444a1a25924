// The scan core of the two guide-store read kernels (memory_top1.cu,
// memory_topk.cu): B queries against a (Cp, Ep) f32 store, Ep % 4 == 0;
// rows lacking any bit of `required` in the (Cp,) int32 mask plane score
// -2.0; the order is (sim descending, row ascending) under IEEE compares,
// so +0.0 == -0.0 and the row decides between them.
//
// What bounds it on the H100 (3.35 TB/s, 67 TFLOP/s f32 FMA, 1.98 GHz):
//   C=4096,  E=384, B=32: 6.3 MB of store (1.9 us) against 50 M FMAs
//     (1.5 us): neither, at 31 rows an SM; latency and launch decide.
//   C=65536, E=384, B=32: 100.7 MB (30 us) against 805 M FMAs (24 us):
//     nearly balanced, so the FMA pipe and HBM must be the only limits.
//
// Design, one pass over the store for all queries:
//   * Queries on chip. A CTA stages its group of up to QB queries (QB = 32,
//     or 8 for B <= 8 or Ep > 512, or 1 for B = 1) into shared memory once,
//     zero-filled past E. B > QB loops over groups inside the CTA (each
//     group reads the CTA's rows again); no query group is a grid axis, so
//     for B <= 32 every store byte leaves HBM once.
//   * Store tiles through a cp.async ring. A tile is R rows (256 for
//     stores of WIDE_MIN_ROWS rows and more, else 32); it is staged in
//     chunks of KC lanes, STAGES chunks in flight, so the next chunk lands
//     while this one is computed (a 32-row tile of 384 lanes is in flight
//     whole from the start). The staged row stride is KC + 4 floats (= 4
//     mod 32 banks): the 8 lanes of a quarter warp reading 8 rows at one
//     lane offset touch every bank once.
//   * Register tiling, no shuffles per row. A thread owns RT rows x QT
//     queries and accumulates whole dots in registers; a k-step loads
//     RT + QT float4s from shared memory for 4 RT QT FMAs. The store
//     operand is per lane and the query operand a broadcast (every lane of
//     a quarter warp reads one address). A broadcast LDS.128 is no cheaper
//     on the H100 than a per-lane one (scripts/store_scan_sweep.py at
//     C=65536, B=32: leaving out the 8 query loads of a k-step saves 16.5
//     us, the 4 store loads 4.6), so what counts is the reuse RT QT /
//     (RT + QT): the 256-row tiles put a warp's lanes on 32 rows (thread
//     tile 4 x 8 at B = 32; 8 x 4, and 8 x 8 or 8 x 4 on 512-row tiles,
//     ran slower), the 32-row tiles on 8 rows x 4 query groups (thread
//     tile 4 x 2), since one lane a row would leave a 32-row tile one row
//     a thread (14.3 against 12.3 us at C=4096, B=32).
//   * Summation order. Every (row, query) dot is summed the same way,
//     whatever the row's tile, CTA, grid or configuration, so identical
//     rows give identical sims and ties fall to the lowest row: an FMA
//     chain from +0.0 over each block of SUM_BLOCK = 32 lanes (ascending),
//     and the blocks' partial sums added in lane order to a total from
//     +0.0. One chain over all 384 lanes strays up to ~1e-6 from the exact
//     dot of a unit row with itself (the card tolerance); the blocks keep
//     it near 2.4e-7 for one FADD per 32 FMAs (tests/
//     test_torch_store_scan_design.py pins it). Plain f32 FMA only: no TF32
//     or tensor cores (sims sit within 1e-6 of the 0.6 routing threshold).
//   * Grid. CTAs = min(tiles, SMs x resident CTAs an SM): 128 CTAs of 32
//     rows at C=4096, 132 persistent CTAs over 256 tiles at C=65536. A CTA
//     walks tiles blockIdx.x, + gridDim.x, ... and its ring runs on across
//     tile boundaries.
//   * Selection and merge in the same launch, after a ticket: the last CTA
//     to take it finishes the read and leaves the workspace ready for the
//     next launch (the wrapper caches it per device, stream and shape; no
//     memset per call):
//       - key mode (top-1, and top-k with k = 1): each thread keeps, per
//         query, the largest 64-bit key (order-preserving sim bits << 32 |
//         0xFFFFFFFF - row) over its rows and tiles; a warp reduces them
//         and merges with one atomicMax per query. -0.0 is packed as +0.0.
//         Top-1 raises every key to the seed (-2.0, row 0), so an empty
//         view gives (-2.0, 0) as the TPU kernel's seeded running best.
//         The last CTA swaps every key back to 0 and unpacks it.
//       - list mode (top-k, k >= 2): after a tile's last chunk its sims go
//         to shared memory and each warp takes k rounds (max, lowest row,
//         consume to -inf) for its queries at once, writing the tile's top-k
//         to the (B, tiles, k) workspace; a tile with fewer real rows than
//         k yields absent (-inf, 2^30) entries. The sorted lists are then
//         merged by k rounds over their heads, in two rounds when a CTA
//         walks several tiles (tiles > grid): each CTA first merges its own
//         tiles' lists, read from L2, into one list a query (a (B, grid, k)
//         workspace after the tile lists), and the last CTA merges the
//         grid's lists; with one tile a CTA the last CTA merges the tile
//         lists themselves. The last CTA stages as many queries' lists as
//         fit in shared memory at once (one L2 round trip a batch). A merge
//         keeps a head a list and warp-query in shared memory, so the two
//         rounds take stores of any size a card holds (a CTA's own heads
//         are ceil(tiles / grid) of them: 1504 tiles a CTA, 50.8M rows, at
//         E = 384 and B = 32), where one merge of every tile list refused
//         past ~385K rows. Any k that check_k admits runs in this one
//         launch.
#pragma once

#include "attention_common.cuh"

#include <algorithm>
#include <mutex>
#include <vector>

namespace {

using repro_attn::cp_async16;
using repro_attn::cp_async_commit;
using repro_attn::cp_async_wait;

constexpr int ROW_SENTINEL = 1 << 30;
constexpr int WIDE_MIN_ROWS = 16384;  // stores this tall take 256-row tiles
constexpr int MAX_EP = 2048;          // widest store row a query group holds
constexpr int SUM_BLOCK = 32;         // lanes a partial FMA chain sums
constexpr size_t MAX_DYN_SMEM = 227 * 1024;

// A warp's lanes are LR rows x LQ = 32 / LR queries (lane = lr + LR lq);
// a thread owns RT rows (lr + LR i) x QT queries (lq + LQ j), so a warp
// covers LR RT rows x LQ QT queries; WR warps along the rows and WQ along
// the queries; chunks of KC lanes, STAGES of them in the ring.
template <int LR_, int RT_, int QT_, int WR_, int WQ_, int KC_, int STAGES_>
struct Cfg {
  static constexpr int LR = LR_, LQ = 32 / LR_, RT = RT_, QT = QT_, WR = WR_, WQ = WQ_;
  static constexpr int KC = KC_, STAGES = STAGES_;
  static constexpr int WARPS = WQ * WR, THREADS = WARPS * 32;
  static constexpr int QB = WQ * LQ * QT;  // queries a group
  static constexpr int R = WR * LR * RT;   // rows a tile
  static constexpr int LD = KC + 4;        // staged row stride, floats
  static constexpr int STAGE = R * LD;     // floats a ring slot
  static constexpr int COPIES = R * (KC / 4) / THREADS;  // cp.async a thread a chunk
  static constexpr int QPW = (QB + WARPS - 1) / WARPS;   // queries a warp selects for at once
  static_assert(R * (KC / 4) % THREADS == 0, "chunk copies must split evenly");
  static_assert(KC % SUM_BLOCK == 0 && STAGES >= 2, "bad ring");
  static_assert(LR * LQ == 32, "a warp is 32 lanes");
  static_assert(R == 32 || R == 256, "the wrapper sizes top-k's lists for these tiles");
};

// wide: 256-row tiles (C >= WIDE_MIN_ROWS); narrow: 32-row tiles, the
// ring deep enough to hold a whole 384-lane tile from the start
using Wide32 = Cfg<32, 4, 8, 2, 4, 32, 3>;    // 8 warps, thread tile 4 x 8
using Narrow32 = Cfg<8, 4, 2, 1, 4, 96, 5>;   // 4 warps of 8 x 4 lanes, 4 x 2
using Wide8 = Cfg<32, 2, 8, 4, 1, 32, 3>;     // 4 warps, thread tile 2 x 8
using Narrow8 = Cfg<8, 2, 2, 2, 1, 96, 5>;    // 2 warps of 8 x 4 lanes, 2 x 2
using Wide1 = Cfg<32, 2, 1, 4, 1, 32, 3>;     // 4 warps, thread tile 2 x 1
using Narrow1 = Cfg<32, 1, 1, 1, 1, 96, 5>;   // 1 warp, thread tile 1 x 1

struct ScanArgs {
  const float* mem;            // (Cp, Ep)
  const float* qs;             // (B, E): rows of E floats, E % 4 == 0, 16-byte aligned
  const int* mask;             // (Cp,) bit plane
  int Cp, Ep, E, B, required;
  int k;                       // entries a query (1 in key mode)
  int tiles;                   // ceil(Cp / R), set at launch
  int capacity;                // list mode: entries cand_s/cand_r hold (3 spare: 16-byte reads)
  int seeded;                  // key mode: raise every key to (-2.0, row 0)
  int smem_floats;             // dynamic shared memory of the launch, floats
  unsigned long long* keys;    // key mode: B keys, 0 between launches
  unsigned int* ticket;        // 0 between launches
  float* cand_s;               // list mode: (B, tiles, k)
  int* cand_r;
  float* out_s;                // (B, k)
  int* out_r;
};

__device__ __forceinline__ bool better(float s, int r, float bs, int br) {
  return s > bs || (s == bs && r < br);
}

__device__ __forceinline__ uint32_t order_bits(float s) {
  const uint32_t u = __float_as_uint(s == 0.f ? 0.f : s);  // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ unsigned long long pack(float s, int row) {
  return ((unsigned long long)order_bits(s) << 32) | (0xffffffffu - (uint32_t)row);
}

// Copy chunk s of this CTA's tile sequence (tile s / nc, lanes from
// (s % nc) * KC) into its ring slot; rows past Cp and lanes past Ep are zero.
template <class C>
__device__ __forceinline__ void stage_chunk(const ScanArgs& a, float* ring, int s, int nc) {
  const int tile = blockIdx.x + (s / nc) * gridDim.x;
  const int row0 = tile * C::R, k0 = (s % nc) * C::KC;
  float* dst = ring + (s % C::STAGES) * C::STAGE;
  constexpr int CPR = C::KC / 4;
#pragma unroll
  for (int j = 0; j < C::COPIES; ++j) {
    const int i = threadIdx.x + j * C::THREADS;
    const int r = i / CPR, e = (i % CPR) * 4;
    const bool ok = row0 + r < a.Cp && k0 + e < a.Ep;
    cp_async16(dst + r * C::LD + e, ok ? a.mem + (size_t)(row0 + r) * a.Ep + k0 + e : a.mem, ok);
  }
}

// A tile's sorted top-k for each query of the group, into the workspace;
// its sims are in `sims` (QB x R).
template <class C>
__device__ __forceinline__ void tile_lists(const ScanArgs& a, const float* sims, int tile,
                                           int q0, int nq) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // a warp selects for QPW queries at once (their rounds interleave)
  constexpr int VPL = C::R / 32;
  const int nreal = min(C::R, a.Cp - tile * C::R);
  float v[C::QPW][VPL];
#pragma unroll
  for (int qi = 0; qi < C::QPW; ++qi) {
    const int qq = warp + qi * C::WARPS;
#pragma unroll
    for (int jj = 0; jj < VPL; ++jj)
      v[qi][jj] = qq < nq ? sims[qq * C::R + jj * 32 + lane] : -INFINITY;
  }
  for (int j = 0; j < a.k; ++j) {
    float bs[C::QPW];
    int bi[C::QPW];
#pragma unroll
    for (int qi = 0; qi < C::QPW; ++qi) {
      bs[qi] = -INFINITY;
      bi[qi] = ROW_SENTINEL;
#pragma unroll
      for (int jj = 0; jj < VPL; ++jj)
        if (better(v[qi][jj], jj * 32 + lane, bs[qi], bi[qi])) {
          bs[qi] = v[qi][jj];
          bi[qi] = jj * 32 + lane;
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int qi = 0; qi < C::QPW; ++qi) {
        const float os = __shfl_xor_sync(0xffffffffu, bs[qi], off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi[qi], off);
        if (better(os, oi, bs[qi], bi[qi])) { bs[qi] = os; bi[qi] = oi; }
      }
    }
#pragma unroll
    for (int qi = 0; qi < C::QPW; ++qi) {
#pragma unroll
      for (int jj = 0; jj < VPL; ++jj)
        if (jj * 32 + lane == bi[qi]) v[qi][jj] = -INFINITY;  // consume
      const int qq = warp + qi * C::WARPS;
      if (lane == 0 && qq < nq) {  // past the tile's real rows: an absent entry
        const size_t at = ((size_t)(q0 + qq) * a.tiles + tile) * a.k + j;
        a.cand_s[at] = j < nreal ? bs[qi] : -INFINITY;
        a.cand_r[at] = j < nreal ? tile * C::R + bi[qi] : ROW_SENTINEL;
      }
    }
  }
}

// nl sorted lists of k entries a query: query q's list t starts at entry
// q * stride + (first + t * step) * k of s and r.
struct Lists {
  const float* s;
  const int* r;
  size_t stride;
  int nl, first, step;
};

// k rounds over the heads of the sorted lists of queries 0..nb-1 (in
// shared memory, or in L2 with GLOBAL): each round takes a query's best
// head, (sim desc, row asc), writes it to (os, orow) at q * ostride + j,
// and advances its list. A warp takes QPW queries at once; `head` holds
// WARPS x QPW x nl ints.
template <class C, bool GLOBAL>
__device__ __forceinline__ void merge_batch(const Lists& l, int k, int nb, float* os, int* orow,
                                            size_t ostride, int* head) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nl = l.nl;
  head += warp * C::QPW * nl;
  for (int c0 = 0; c0 < nb; c0 += C::WARPS * C::QPW) {
    for (int t = lane; t < C::QPW * nl; t += 32) head[t] = 0;
    __syncwarp();
    for (int j = 0; j < k; ++j) {
      float bs[C::QPW];
      int br[C::QPW], bt[C::QPW];
#pragma unroll
      for (int qi = 0; qi < C::QPW; ++qi) {
        bs[qi] = -INFINITY;
        br[qi] = ROW_SENTINEL;
        bt[qi] = -1;
        const int bb = c0 + warp + qi * C::WARPS;
        if (bb >= nb) continue;
        for (int t = lane; t < nl; t += 32) {
          const int p = head[qi * nl + t];
          if (p >= k) continue;
          const size_t i = (size_t)bb * l.stride + (size_t)(l.first + t * l.step) * k + p;
          const float hs = GLOBAL ? __ldcg(l.s + i) : l.s[i];
          const int hr = GLOBAL ? __ldcg(l.r + i) : l.r[i];
          if (better(hs, hr, bs[qi], br[qi])) { bs[qi] = hs; br[qi] = hr; bt[qi] = t; }
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int qi = 0; qi < C::QPW; ++qi) {
          const float o_s = __shfl_xor_sync(0xffffffffu, bs[qi], off);
          const int o_r = __shfl_xor_sync(0xffffffffu, br[qi], off);
          const int o_t = __shfl_xor_sync(0xffffffffu, bt[qi], off);
          if (better(o_s, o_r, bs[qi], br[qi])) { bs[qi] = o_s; br[qi] = o_r; bt[qi] = o_t; }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int qi = 0; qi < C::QPW; ++qi) {
          const int bb = c0 + warp + qi * C::WARPS;
          if (bb >= nb) continue;
          os[(size_t)bb * ostride + j] = bs[qi];
          orow[(size_t)bb * ostride + j] = br[qi];
          if (bt[qi] >= 0) ++head[qi * nl + bt[qi]];
        }
      }
      __syncwarp();
    }
  }
}

// Where list mode's lists are: the (B, tiles, k) tile lists, and when the
// merge takes two rounds (tiles > grid) the (B, grid, k) CTA lists after
// them, from a 4-entry boundary (the last CTA copies them 16 bytes at a
// time).
__host__ __device__ __forceinline__ bool two_rounds(int tiles, int grid) { return tiles > grid; }
__host__ __device__ __forceinline__ size_t cta_lists_at(int B, int tiles, int k) {
  return ((size_t)B * tiles * k + 3) / 4 * 4;
}

// Round one of a two-round merge, by every CTA after its walk over a query
// group's tiles: its own tiles' lists (tiles blockIdx.x, + gridDim.x, ...,
// read from L2) into one list a query of the group, at its slot of the CTA
// lists. The whole shared memory is idle here (the next group restages
// it), so it holds the heads.
template <class C>
__device__ __forceinline__ void merge_own_tiles(const ScanArgs& a, float* smem, int q0, int nq) {
  __syncthreads();  // every tile list of the group is written; the ring and sims are idle
  const int mine = (a.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const size_t stride = (size_t)a.tiles * a.k, base = (size_t)q0 * stride;
  const size_t out = cta_lists_at(a.B, a.tiles, a.k) + ((size_t)q0 * gridDim.x + blockIdx.x) * a.k;
  const Lists l{a.cand_s + base, a.cand_r + base, stride, mine, (int)blockIdx.x, (int)gridDim.x};
  merge_batch<C, true>(l, a.k, nq, a.cand_s + out, a.cand_r + out, (size_t)gridDim.x * a.k,
                       reinterpret_cast<int*>(smem));
}

// The last CTA: merge each query's sorted lists (nl of them, at entry `at`
// of the workspace, n = nl * k a query) into the output. As many queries'
// lists as fit are staged in shared memory at once by the whole CTA
// (16-byte cp.async, all in flight together: one L2 round trip a batch),
// then merged; lists too long for shared memory are merged from L2.
template <class C>
__device__ __forceinline__ void merge_lists(const ScanArgs& a, float* smem, size_t at, int nl) {
  const int k = a.k, n = nl * k;
  int* head = reinterpret_cast<int*>(smem);  // WARPS x QPW lists' heads
  float* stage = smem + (C::WARPS * C::QPW * nl + 3) / 4 * 4;
  const int room = a.smem_floats - (int)(stage - smem) - 16;  // 4 floats of slack a side
  const int batch = room / (2 * n);
  if (batch < 1) {
    merge_batch<C, true>(Lists{a.cand_s + at, a.cand_r + at, (size_t)n, nl, 0, 1}, k, a.B,
                         a.out_s, a.out_r, k, head);
    return;
  }
  for (int b0 = 0; b0 < a.B; b0 += batch) {
    // queries b0 .. b0 + nb - 1: entries [o, o + total) of the workspace,
    // copied 16 bytes at a time from the 4-float boundary below o
    const int nb = min(batch, a.B - b0), total = nb * n;
    const size_t o = at + (size_t)b0 * n, o4 = o & ~(size_t)3;
    const int quads = (int)((o + total + 3 - o4) / 4), span = quads * 4;
    float* ss = stage;
    int* sr = reinterpret_cast<int*>(stage + span);
    __syncthreads();  // the last batch is merged
    for (int i = threadIdx.x; i < quads; i += C::THREADS) {
      cp_async16(ss + 4 * i, a.cand_s + o4 + 4 * i, true);
      cp_async16(sr + 4 * i, a.cand_r + o4 + 4 * i, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    merge_batch<C, false>(Lists{ss + (o - o4), sr + (o - o4), (size_t)n, nl, 0, 1}, k, nb,
                          a.out_s + (size_t)b0 * k, a.out_r + (size_t)b0 * k, k, head);
  }
}

// The scan: each kernel (top1_scan_kernel, topk_scan_kernel) is this body.
template <class C, bool LISTS>
__device__ __forceinline__ void scan_body(const ScanArgs& a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool last;
  const int nc = (a.Ep + C::KC - 1) / C::KC, ek = nc * C::KC;
  float* ring = smem;
  float* qsm = ring + C::STAGES * C::STAGE;
  float* sims = qsm + C::QB * ek;  // list mode: (QB, R)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wq = warp % C::WQ, wr = warp / C::WQ, lr = lane % C::LR, lq = lane / C::LR;
  const int row_in = wr * C::LR * C::RT + lr;  // this thread's rows: row_in + LR r
  const int q_in = wq * C::LQ * C::QT + lq;    // and queries: q_in + LQ q
  const int ns = ((a.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * nc;
  const unsigned long long seed = a.seeded ? pack(-2.0f, 0) : 0ull;

  for (int q0 = 0; q0 < a.B; q0 += C::QB) {
    const int nq = min(C::QB, a.B - q0);
    __syncthreads();  // the last group is done with the queries and the ring
    for (int i = threadIdx.x; i < C::QB * (ek / 4); i += C::THREADS) {
      const int q = i / (ek / 4), e = (i % (ek / 4)) * 4;
      const bool ok = q < nq && e < a.E;
      cp_async16(qsm + q * ek + e, ok ? a.qs + (size_t)(q0 + q) * a.E + e : a.qs, ok);
    }
#pragma unroll
    for (int s = 0; s < C::STAGES - 1; ++s) {  // the queries ride in group 0
      if (s < ns) stage_chunk<C>(a, ring, s, nc);
      cp_async_commit();
    }
    float part[C::RT][C::QT], dot[C::RT][C::QT];  // a block's chain; the total
    unsigned long long best[C::QT];
    int bits[C::RT] = {};
#pragma unroll
    for (int q = 0; q < C::QT; ++q) {
      best[q] = 0ull;
#pragma unroll
      for (int r = 0; r < C::RT; ++r) part[r][q] = dot[r][q] = 0.f;
    }
    for (int g = 0; g < ns; ++g) {
      cp_async_wait<C::STAGES - 2>();
      __syncthreads();  // chunk g landed for every thread; slot g - 1 is free
      if (g + C::STAGES - 1 < ns) stage_chunk<C>(a, ring, g + C::STAGES - 1, nc);
      cp_async_commit();
      const int c = g % nc;
      const int tile = blockIdx.x + (g / nc) * gridDim.x;
      if (c == 0) {
#pragma unroll
        for (int r = 0; r < C::RT; ++r) {
          const int row = tile * C::R + row_in + r * C::LR;
          bits[r] = row < a.Cp ? __ldg(a.mask + row) : 0;
        }
      }
      const float* st = ring + (g % C::STAGES) * C::STAGE + row_in * C::LD;
      const float* qb = qsm + q_in * ek + c * C::KC;
#pragma unroll
      for (int kk = 0; kk < C::KC; kk += 4) {
        float4 m[C::RT];
#pragma unroll
        for (int r = 0; r < C::RT; ++r)
          m[r] = *reinterpret_cast<const float4*>(st + r * C::LR * C::LD + kk);
#pragma unroll
        for (int q = 0; q < C::QT; ++q) {
          const float4 x = *reinterpret_cast<const float4*>(qb + q * C::LQ * ek + kk);
#pragma unroll
          for (int r = 0; r < C::RT; ++r) {
            part[r][q] = fmaf(m[r].x, x.x, part[r][q]);
            part[r][q] = fmaf(m[r].y, x.y, part[r][q]);
            part[r][q] = fmaf(m[r].z, x.z, part[r][q]);
            part[r][q] = fmaf(m[r].w, x.w, part[r][q]);
          }
        }
        if ((kk + 4) % SUM_BLOCK == 0) {  // a block of lanes is summed
#pragma unroll
          for (int r = 0; r < C::RT; ++r)
#pragma unroll
            for (int q = 0; q < C::QT; ++q) {
              dot[r][q] += part[r][q];
              part[r][q] = 0.f;
            }
        }
      }
      if (c == nc - 1) {  // the tile's dots are whole
        if constexpr (LISTS) {
#pragma unroll
          for (int r = 0; r < C::RT; ++r) {
            const int i = row_in + r * C::LR, row = tile * C::R + i;
            const bool valid = (bits[r] & a.required) == a.required;
#pragma unroll
            for (int q = 0; q < C::QT; ++q)
              sims[(q_in + q * C::LQ) * C::R + i] =
                  row < a.Cp ? (valid ? dot[r][q] : -2.0f) : -INFINITY;
          }
          __syncthreads();
          tile_lists<C>(a, sims, tile, q0, nq);
        } else {
#pragma unroll
          for (int r = 0; r < C::RT; ++r) {
            const int row = tile * C::R + row_in + r * C::LR;
            if (row >= a.Cp) continue;
            const bool valid = (bits[r] & a.required) == a.required;
#pragma unroll
            for (int q = 0; q < C::QT; ++q) {
              const unsigned long long key = pack(valid ? dot[r][q] : -2.0f, row);
              best[q] = key > best[q] ? key : best[q];
            }
          }
        }
#pragma unroll
        for (int r = 0; r < C::RT; ++r)
#pragma unroll
          for (int q = 0; q < C::QT; ++q) dot[r][q] = 0.f;
      }
    }
    if constexpr (LISTS) {
      if (two_rounds(a.tiles, gridDim.x)) merge_own_tiles<C>(a, smem, q0, nq);
    } else {
#pragma unroll
      for (int q = 0; q < C::QT; ++q) {
        unsigned long long key = best[q] > seed ? best[q] : seed;
        for (int off = C::LR / 2; off > 0; off >>= 1) {  // over the lanes' rows
          const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, off);
          key = o > key ? o : key;
        }
        const int qq = q_in + q * C::LQ;
        if (lr == 0 && qq < nq) atomicMax(a.keys + q0 + qq, key);
      }
    }
  }

  // the last CTA to finish completes the read and resets the workspace
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if constexpr (LISTS) {
    if (two_rounds(a.tiles, gridDim.x))
      merge_lists<C>(a, smem, cta_lists_at(a.B, a.tiles, a.k), gridDim.x);
    else
      merge_lists<C>(a, smem, 0, a.tiles);
  } else {
    for (int b = threadIdx.x; b < a.B; b += C::THREADS) {
      const unsigned long long key = atomicExch(a.keys + b, 0ull);
      a.out_s[b] = from_order_bits((uint32_t)(key >> 32));
      a.out_r[b] = (int)(0xffffffffu - (uint32_t)key);
    }
  }
  if (threadIdx.x == 0) *a.ticket = 0u;
}

// Once per kernel, device and shared-memory size: raise the kernel's
// dynamic shared-memory limit, and read how many CTAs an SM holds and how
// many SMs the device has (host calls of microseconds, kept off the
// per-launch path).
template <auto Kernel>
cudaError_t prepare(int threads, size_t bytes, int* resident) {
  struct Seen { int dev; size_t bytes; int resident; };
  static std::mutex mu;
  static std::vector<Seen> seen;
  static size_t allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(mu);
  for (const Seen& s : seen)
    if (s.dev == dev && s.bytes == bytes) { *resident = s.resident; return cudaSuccess; }
  if (bytes > allowed[dev]) {
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    allowed[dev] = bytes;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, threads, bytes);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  seen.push_back({dev, bytes, per_sm * sms});
  *resident = per_sm * sms;
  return cudaSuccess;
}

// Shared memory of one launch, in floats: the ring, the query group, and in
// list mode a tile's sims.
template <class C, bool LISTS>
size_t launch_floats(int Ep) {
  const size_t ek = (size_t)(Ep + C::KC - 1) / C::KC * C::KC;
  return (size_t)C::STAGES * C::STAGE + C::QB * ek + (LISTS ? (size_t)C::QB * C::R : 0);
}

// Launch Kernel (a __global__ wrapper of scan_body<C, LISTS>) on `a`.
template <class C, bool LISTS, auto Kernel>
cudaError_t launch(ScanArgs a, cudaStream_t stream) {
  const size_t floats = launch_floats<C, LISTS>(a.Ep), bytes = floats * sizeof(float);
  a.tiles = (a.Cp + C::R - 1) / C::R;
  if (bytes > MAX_DYN_SMEM) return cudaErrorInvalidValue;
  int resident = 0;
  const cudaError_t err = prepare<Kernel>(C::THREADS, bytes, &resident);
  if (err != cudaSuccess) return err;
  const int grid = std::min(a.tiles, resident);
  if (LISTS) {
    // a merge's heads (a CTA's own tiles, then the grid's lists, or the
    // tiles' lists in one round) and the workspace's entries
    const bool two = two_rounds(a.tiles, grid);
    const size_t heads = (size_t)C::WARPS * C::QPW * (two ? (a.tiles + grid - 1) / grid : 0);
    const size_t last = (size_t)C::WARPS * C::QPW * (two ? grid : a.tiles);
    const size_t need = two ? cta_lists_at(a.B, a.tiles, a.k) + (size_t)a.B * grid * a.k
                            : (size_t)a.B * a.tiles * a.k;
    if (heads > floats || last > floats || need + 3 > (size_t)a.capacity)
      return cudaErrorInvalidValue;
  }
  a.smem_floats = (int)floats;
  void* args[] = {&a};
  const cudaError_t launched = cudaLaunchKernel((const void*)Kernel, dim3(grid),
                                                dim3(C::THREADS), args, bytes, stream);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

bool valid_args(const ScanArgs& a) {
  const uintptr_t aligned = reinterpret_cast<uintptr_t>(a.mem) | reinterpret_cast<uintptr_t>(a.qs);
  return a.Cp >= 1 && a.B >= 1 && a.k >= 1 && a.Ep >= 4 && a.Ep % 4 == 0 && a.Ep <= MAX_EP &&
         a.E >= 4 && a.E % 4 == 0 && a.E <= a.Ep && aligned % 16 == 0 && a.keys != nullptr;
}

}  // namespace
