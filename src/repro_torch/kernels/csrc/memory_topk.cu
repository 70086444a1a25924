// Masked multi-query top-k over the padded guide store (the RAR store read).
//
// Replaces src/repro/kernels/memory_topk.py::memory_topk_batch_padded_pallas
// (body _topk_batch_kernel, merge _select_topk). Same function: B queries
// against a (Cp, Ep) f32 store; rows lacking any bit of `required` in the
// (Cp, 1) int32 mask plane score -2.0; each query keeps the top-k rows by
// (sim descending, row ascending), IEEE compares (so +0.0 == -0.0 and only
// the row decides between them).
//
// Bound on the H100: HBM bytes. Every store byte is read once per query
// group: Cp * Ep * 4 bytes (6.3 MB at the default 4096 x 384 store, about
// 1.9 us at 3.35 TB/s), so at the main path's sizes the launch cost
// dominates. Design: the TPU kernel carries a (k, B) accumulator across a
// sequential grid; CTAs on Hopper run in no order, so the scan is split in
// two passes:
//   1. one CTA per (128-row block, 8-query group): each warp takes rows,
//      loads each row once as float4 lines and dots it against the group's
//      queries with plain f32 FMA -- no TF32/tensor cores, since sims sit
//      within 1e-6 of sim_threshold and a rounding flip would change
//      routing; then warp q runs k selection rounds (max -> lowest row ->
//      consume) over the block for query q and writes the block's top-k.
//   2. one CTA per query merges the blocks' candidates with the same rounds.
// The top-k of a union is the top-k of the per-block top-ks under a strict
// total order, so the result equals one global selection. Consumed and
// absent candidates are -inf (never re-selected); the reference consumes to
// -3.0, which differs only if a view holds sims below -3.0 (impossible for
// the store's unit-or-zero rows and unit queries).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 128;   // store rows per pass-1 CTA
constexpr int WARPS = 8;
constexpr int QB = WARPS;   // queries per pass-1 CTA: warp w selects for query w
constexpr int THREADS = WARPS * 32;
constexpr int ROW_SENTINEL = 1 << 30;

__device__ __forceinline__ bool better(float s, int r, float bs, int br) {
  return s > bs || (s == bs && r < br);
}

__device__ __forceinline__ void warp_best(float& s, int& r, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, s, off);
    const int orow = __shfl_xor_sync(0xffffffffu, r, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(os, orow, s, r)) { s = os; r = orow; i = oi; }
  }
}

__global__ void __launch_bounds__(THREADS)
topk_block_kernel(const float* __restrict__ mem, const float* __restrict__ qs,
                  const int* __restrict__ mask, int Cp, int Ep, int B, int k, int required,
                  float* __restrict__ cand_s, int* __restrict__ cand_r) {
  __shared__ float sims[QB][ROWS];
  const int blk = blockIdx.x, nblk = gridDim.x, q0 = blockIdx.y * QB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = min(QB, B - q0);
  const int row0 = blk * ROWS;
  const int nreal = min(ROWS, Cp - row0);

  for (int rr = warp; rr < ROWS; rr += WARPS) {
    const int row = row0 + rr;
    if (rr >= nreal) {
      if (lane < QB) sims[lane][rr] = -INFINITY;
      continue;
    }
    float acc[QB];
#pragma unroll
    for (int q = 0; q < QB; ++q) acc[q] = 0.f;
    const float* mrow = mem + (size_t)row * Ep;
    for (int e = lane * 4; e < Ep; e += 128) {
      const float4 m = *reinterpret_cast<const float4*>(mrow + e);
#pragma unroll
      for (int q = 0; q < QB; ++q) {
        if (q < nq) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(qs + (size_t)(q0 + q) * Ep + e));
          acc[q] = fmaf(m.x, x.x, acc[q]);
          acc[q] = fmaf(m.y, x.y, acc[q]);
          acc[q] = fmaf(m.z, x.z, acc[q]);
          acc[q] = fmaf(m.w, x.w, acc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < QB; ++q)
      for (int off = 16; off > 0; off >>= 1) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
    const bool valid = (mask[row] & required) == required;
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < QB; ++q) sims[q][rr] = valid ? acc[q] : -2.0f;
    }
  }
  __syncthreads();

  const int q = warp;
  if (q >= nq) return;
  float* out_s = cand_s + ((size_t)(q0 + q) * nblk + blk) * k;
  int* out_r = cand_r + ((size_t)(q0 + q) * nblk + blk) * k;
  const int kk = min(k, nreal);
  for (int j = 0; j < k; ++j) {
    if (j >= kk) {  // fewer real rows than k in this block: absent candidates
      if (lane == 0) { out_s[j] = -INFINITY; out_r[j] = ROW_SENTINEL; }
      continue;
    }
    float bs = -INFINITY;
    int br = ROW_SENTINEL, bi = -1;
    for (int i = lane; i < nreal; i += 32) {
      const float s = sims[q][i];
      if (better(s, row0 + i, bs, br)) { bs = s; br = row0 + i; bi = i; }
    }
    warp_best(bs, br, bi);
    if (lane == 0) { out_s[j] = bs; out_r[j] = br; }
    if (bi >= 0 && (bi & 31) == lane) sims[q][bi] = -INFINITY;  // consume
    __syncwarp();
  }
}

__global__ void __launch_bounds__(THREADS)
topk_merge_kernel(float* __restrict__ cand_s, const int* __restrict__ cand_r, int n, int k,
                  float* __restrict__ out_s, int* __restrict__ out_r) {
  __shared__ float ws[WARPS];
  __shared__ int wr[WARPS], wi[WARPS];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* cs = cand_s + (size_t)b * n;
  const int* cr = cand_r + (size_t)b * n;
  for (int j = 0; j < k; ++j) {
    float bs = -INFINITY;
    int br = ROW_SENTINEL, bi = -1;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const float s = cs[i];
      const int r = cr[i];
      if (better(s, r, bs, br)) { bs = s; br = r; bi = i; }
    }
    warp_best(bs, br, bi);
    if (lane == 0) { ws[warp] = bs; wr[warp] = br; wi[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bs = lane < WARPS ? ws[lane] : -INFINITY;
      br = lane < WARPS ? wr[lane] : ROW_SENTINEL;
      bi = lane < WARPS ? wi[lane] : -1;
      warp_best(bs, br, bi);
      if (lane == 0) {
        out_s[(size_t)b * k + j] = bs;
        out_r[(size_t)b * k + j] = br;
        if (bi >= 0) cs[bi] = -INFINITY;  // consume
      }
    }
    __syncthreads();
  }
}

}  // namespace

// mem (Cp, Ep) f32, qs (B, Ep) f32 (lane-padded), mask (Cp,) int32;
// scratch cand_s/cand_r hold B * ceil(Cp / 128) * k entries; outputs (B, k).
extern "C" int memory_topk_batch_padded(const float* mem, const float* qs, const int* mask,
                                        int Cp, int Ep, int B, int k, int required,
                                        float* cand_s, int* cand_r, float* out_s, int* out_r,
                                        cudaStream_t stream) {
  if (Ep % 4 != 0 || k < 1 || k > Cp) return cudaErrorInvalidValue;
  const int nblk = (Cp + ROWS - 1) / ROWS;
  dim3 grid(nblk, (B + QB - 1) / QB);
  topk_block_kernel<<<grid, THREADS, 0, stream>>>(mem, qs, mask, Cp, Ep, B, k, required, cand_s,
                                                  cand_r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  topk_merge_kernel<<<B, THREADS, 0, stream>>>(cand_s, cand_r, nblk * k, k, out_s, out_r);
  return cudaGetLastError();
}

