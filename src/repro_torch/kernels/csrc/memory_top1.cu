// Masked multi-query top-1 over the padded guide store (memory.query and
// memory.query_batch).
//
// Replaces src/repro/kernels/memory_topk.py::memory_top1_batch_padded_pallas
// (body _top1_batch_kernel) and ::memory_top1_padded_pallas (body
// _top1_kernel; here the same kernel with one query). Same function: B
// queries against a (Cp, Ep) f32 store; rows lacking any bit of `required`
// in the (Cp, 1) int32 mask plane score -2.0; each query keeps the max sim,
// ties to the lowest row. The TPU kernel's running best starts at
// (-2.0, row 0) and moves only on a strictly greater sim, so an empty view
// gives (-2.0, 0); so does this one.
//
// Bound on the H100: HBM bytes, the store read once, Cp * Ep * 4 bytes
// (100.7 MB at 65536 x 384: about 30 us at 3.35 TB/s).
//
// Design: the TPU carries the running best in SMEM/VMEM across a
// sequential grid; CTAs on Hopper run in no order, so the global merge is
// an atomic instead:
//   * one CTA per (128-row block, group of up to QB queries), 8 warps; each
//     warp dots whole rows against the group's queries with float4 loads
//     and plain f32 FMA (no TF32: sims sit within 1e-6 of the 0.6
//     threshold and routing must not flip), so each store byte is read
//     once per query group (once in all for B <= 32);
//   * the block's best per query goes into a 64-bit key, the sim's
//     order-preserving bits above 0xFFFFFFFF - row, merged with one
//     atomicMax: the largest key is the largest sim and, among equal sims,
//     the lowest row. -0.0 is packed as +0.0 (the reference compares IEEE
//     and lets the row decide between them);
//   * keys start at 0 (a memset) and every block key is raised to the seed
//     (-2.0, row 0) before the atomic, so the result is at least the seed;
//   * the last CTA to finish (a ticket counter after a fence) unpacks every
//     query's key into its sim bits and row: one launch, no second pass
//     (the top-k kernel needs two), and the sim is the row's own bits (a
//     sim of -0.0 comes back as +0.0).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;  // store rows per CTA
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROW_SENTINEL = 1 << 30;

__device__ __forceinline__ bool better(float s, int r, float bs, int br) {
  return s > bs || (s == bs && r < br);
}

__device__ __forceinline__ uint32_t order_bits(float s) {
  uint32_t u = __float_as_uint(s == 0.f ? 0.f : s);  // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ unsigned long long pack(float s, int row) {
  return ((unsigned long long)order_bits(s) << 32) | (0xffffffffu - (uint32_t)row);
}

template <int QB>
__global__ void __launch_bounds__(THREADS)
top1_kernel(const float* __restrict__ mem, const float* __restrict__ qs,
            const int* __restrict__ mask, int Cp, int Ep, int B, int required,
            unsigned long long* keys, unsigned int* ticket, float* __restrict__ out_s,
            int* __restrict__ out_r) {
  __shared__ float sims[QB][ROWS];
  __shared__ bool last;
  const int row0 = blockIdx.x * ROWS, q0 = blockIdx.y * QB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = min(QB, B - q0);
  const int nreal = min(ROWS, Cp - row0);

  for (int rr = warp; rr < nreal; rr += WARPS) {
    float acc[QB];
#pragma unroll
    for (int q = 0; q < QB; ++q) acc[q] = 0.f;
    const float* mrow = mem + (size_t)(row0 + rr) * Ep;
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
    const bool valid = (mask[row0 + rr] & required) == required;
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < QB; ++q) sims[q][rr] = valid ? acc[q] : -2.0f;
    }
  }
  __syncthreads();

  for (int q = warp; q < nq; q += WARPS) {
    float bs = -INFINITY;
    int br = ROW_SENTINEL;
    for (int i = lane; i < nreal; i += 32) {
      const float s = sims[q][i];
      if (better(s, row0 + i, bs, br)) { bs = s; br = row0 + i; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, off);
      const int orow = __shfl_xor_sync(0xffffffffu, br, off);
      if (better(os, orow, bs, br)) { bs = os; br = orow; }
    }
    if (lane == 0) {
      unsigned long long key = pack(bs, br);
      const unsigned long long seed = pack(-2.0f, 0);
      atomicMax(keys + q0 + q, key > seed ? key : seed);
    }
  }

  // last CTA done: unpack every query's key
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int b = threadIdx.x; b < B; b += THREADS) {
    const unsigned long long key = *(volatile unsigned long long*)(keys + b);
    out_s[b] = from_order_bits((uint32_t)(key >> 32));
    out_r[b] = (int)(0xffffffffu - (uint32_t)key);
  }
}

template <int QB>
cudaError_t launch(const float* mem, const float* qs, const int* mask, int Cp, int Ep, int B,
                   int required, unsigned long long* keys, float* out_s, int* out_r,
                   cudaStream_t stream) {
  dim3 grid((Cp + ROWS - 1) / ROWS, (B + QB - 1) / QB);
  top1_kernel<QB><<<grid, THREADS, 0, stream>>>(mem, qs, mask, Cp, Ep, B, required, keys,
                                                reinterpret_cast<unsigned int*>(keys + B),
                                                out_s, out_r);
  return cudaGetLastError();
}

}  // namespace

// mem (Cp, Ep) f32, qs (B, Ep) f32 (lane-padded), mask (Cp,) int32;
// scratch holds B + 1 64-bit words (B keys, then the ticket counter) and is
// zeroed here; outputs sims (B,) f32 and rows (B,) int32.
extern "C" int memory_top1_batch_padded(const float* mem, const float* qs, const int* mask,
                                        int Cp, int Ep, int B, int required,
                                        unsigned long long* scratch, float* out_s, int* out_r,
                                        cudaStream_t stream) {
  if (Ep % 4 != 0 || Cp < 1 || B < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(unsigned long long) * (B + 1), stream);
  if (err != cudaSuccess) return err;
  if (B == 1) return launch<1>(mem, qs, mask, Cp, Ep, B, required, scratch, out_s, out_r, stream);
  if (B <= 8) return launch<8>(mem, qs, mask, Cp, Ep, B, required, scratch, out_s, out_r, stream);
  return launch<32>(mem, qs, mask, Cp, Ep, B, required, scratch, out_s, out_r, stream);
}
