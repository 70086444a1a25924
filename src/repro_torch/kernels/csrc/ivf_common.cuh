// Pieces shared by the IVF read's two kernels (ivf_route.cu, ivf_scan.cu):
// the dots of a few staged rows against a few staged queries in the scan
// core's summation order, a warp's sort of 32 64-bit keys, and a warp's
// merge of sorted per-tile lists, all in CTAs of 128 threads.
//
// A (sim, id) pair travels as the scan core's 64-bit key (store_scan.cuh,
// pack): the sim's order-preserving bits over 0xFFFFFFFF - id, so a larger
// key is a larger sim or, at an equal sim, a lower id; ids are distinct,
// so keys are, and key 0 (below every real key) marks an absent entry.
#pragma once

#include "store_scan.cuh"

namespace {

constexpr int TILE = 32;      // rows (candidates) a tile
constexpr int NTHREADS = 128; // threads a CTA
using u64 = unsigned long long;

__device__ __forceinline__ float key_sim(u64 key) { return from_order_bits((uint32_t)(key >> 32)); }
__device__ __forceinline__ int key_id(u64 key) { return (int)(0xffffffffu - (uint32_t)key); }

// Shared memory of the dots, in floats: TILE staged rows of stride Ep + 4
// (4 mod 32 banks: a quarter warp's float4 reads of 8 rows at one lane
// offset touch every bank once), NQ staged queries of Ep, and the blocks'
// partial sums, stride nb + 1.
__host__ __device__ inline int row_stride(int Ep) { return Ep + 4; }
__host__ __device__ inline int n_blocks(int Ep) { return (Ep + SUM_BLOCK - 1) / SUM_BLOCK; }
__host__ __device__ inline size_t dot_floats(int Ep, int nq) {
  return (size_t)TILE * row_stride(Ep) + (size_t)nq * Ep + (size_t)nq * TILE * (n_blocks(Ep) + 1);
}

// The dots of the nrows <= TILE staged rows (rows, stride row_stride(Ep))
// against the nq <= NQ staged queries (qs, stride Ep), summed as the scan
// core sums them: the FMA chain of lanes 32w .. 32w + 31 from +0.0 (one
// thread a (row, block) pair, for every query at once), then the blocks'
// sums added in order to a total from +0.0. Thread q * TILE + r returns
// query q's dot of row r (0 where r >= nrows or q >= nq). Every thread of
// the CTA must call it. parts holds rows q * TILE + r of nb + 1 floats.
template <int NQ>
__device__ float tile_dots(const float* rows, const float* qs, float* parts, int Ep, int nq,
                           int nrows) {
  const int ld = row_stride(Ep), nb = n_blocks(Ep);
  for (int i = threadIdx.x; i < nrows * nb; i += NTHREADS) {
    const int r = i % nrows, w = i / nrows;
    const int e1 = min(SUM_BLOCK * (w + 1), Ep);
    float part[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) part[q] = 0.f;
    for (int e = SUM_BLOCK * w; e < e1; e += 4) {
      const float4 m = *reinterpret_cast<const float4*>(rows + r * ld + e);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (q >= nq) break;
        const float4 x = *reinterpret_cast<const float4*>(qs + q * Ep + e);
        part[q] = fmaf(m.x, x.x, part[q]);
        part[q] = fmaf(m.y, x.y, part[q]);
        part[q] = fmaf(m.z, x.z, part[q]);
        part[q] = fmaf(m.w, x.w, part[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      if (q < nq) parts[(q * TILE + r) * (nb + 1) + w] = part[q];
  }
  __syncthreads();
  float dot = 0.f;
  if (threadIdx.x < nq * TILE && threadIdx.x % TILE < nrows)
    for (int w = 0; w < nb; ++w) dot += parts[threadIdx.x * (nb + 1) + w];
  return dot;
}

// The warp's 32 keys sorted descending across its lanes (bitonic network
// over shuffles): lane j returns the j-th largest.
__device__ __forceinline__ u64 warp_sort_desc(u64 key) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const u64 other = __shfl_xor_sync(0xffffffffu, key, stride);
      const bool keep_max = ((lane & size) == 0) == ((lane & stride) == 0);
      key = keep_max ? (other > key ? other : key) : (other < key ? other : key);
    }
  }
  return key;
}

__device__ __forceinline__ u64 load_key(const u64* p, bool global) {
  return global ? __ldcg(p) : *p;
}

// The warp's largest key: the largest high word (the sim's order bits),
// then the largest low word among the lanes holding it; two warp
// reductions (REDUX) where a 64-bit max by shuffles takes five steps.
__device__ __forceinline__ u64 warp_max(u64 key) {
  const unsigned top = (unsigned)(key >> 32);
  const unsigned hi = __reduce_max_sync(0xffffffffu, top);
  const unsigned lo = __reduce_max_sync(0xffffffffu, top == hi ? (unsigned)key : 0u);
  return ((u64)hi << 32) | lo;
}

// One warp merges nl descending lists of len keys (at l; absent entries 0)
// into their n largest keys, out[0..n): n rounds, each taking the largest
// list head (a max over the lane's lists, then warp_max) and advancing
// that list. With nl <= 32 a lane holds its list's head in a register;
// else heads (nl ints) and cur (nl keys, the lists' heads) are this warp's
// shared memory. The lists are in shared memory, or in L2 (global).
__device__ void warp_merge(const u64* l, int nl, int len, int n, bool global, int* heads,
                           u64* cur, u64* out) {
  const int lane = threadIdx.x & 31;
  if (nl <= 32) {
    int h = 0;
    u64 c = lane < nl ? load_key(l + (size_t)lane * len, global) : 0ull;
    for (int r = 0; r < n; ++r) {
      const u64 best = warp_max(c);
      if (lane < nl && c == best && best != 0ull) {  // keys are distinct: one lane
        ++h;
        c = h < len ? load_key(l + (size_t)lane * len + h, global) : 0ull;
      }
      if (lane == 0) out[r] = best;
    }
    return;
  }
  for (int j = lane; j < nl; j += 32) {
    heads[j] = 0;
    cur[j] = load_key(l + (size_t)j * len, global);
  }
  __syncwarp();
  for (int r = 0; r < n; ++r) {
    u64 mine = 0ull;
    int at = -1;
    for (int j = lane; j < nl; j += 32) {
      const u64 c = cur[j];
      if (c > mine) { mine = c; at = j; }
    }
    const u64 best = warp_max(mine);
    if (at >= 0 && mine == best && best != 0ull) {
      const int h = ++heads[at];
      cur[at] = h < len ? load_key(l + (size_t)at * len + h, global) : 0ull;
    }
    if (lane == 0) out[r] = best;
    __syncwarp();
  }
}

// The last CTA's merge of nq <= 4 queries' lists (query q's nl lists of len
// keys at lists + q * nl * len, written by other CTAs): warp q merges query
// q into out[q * n .. q * n + n). The lists are staged in shared memory
// first (work, room keys) when they fit beside the warps' state, else read
// from L2. Every thread of the CTA calls it.
__device__ void merge_lists_by_warp(const u64* lists, int nq, int nl, int len, int n, u64* work,
                                    int room, u64* out) {
  const int T = nl * len, state = nl + (nl + 1) / 2;  // cur keys, then heads
  const bool staged = (long long)nq * (T + state) <= room;
  u64* st = staged ? work + (size_t)nq * T : work;
  if (staged)
    for (int i = threadIdx.x; i < nq * T; i += NTHREADS) work[i] = __ldcg(lists + i);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp < nq) {
    u64* cur = st + (size_t)warp * state;
    warp_merge((staged ? work : lists) + (size_t)warp * T, nl, len, n, !staged,
               reinterpret_cast<int*>(cur + nl), cur, out + (size_t)warp * n);
  }
  __syncthreads();
}

}  // namespace
