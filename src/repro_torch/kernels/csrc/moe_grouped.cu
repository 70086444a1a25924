// Grouped expert products of a dropless MoE layer, over the routed slots only.
//
// Replaces no Pallas kernel: the JAX package leaves the expert products to
// XLA as batched matmuls over a (B, E, C, D) dispatch buffer, and at a
// dropless capacity (C = S) a batched product over every slot does E / k
// times the routed work (8x for OLMoE). Here the slots come sorted by expert
// (A: (N, K) bf16 rows, expert e's in rows [offsets[e], offsets[e + 1])),
// and two launches a layer compute, for each slot, with its expert's
// weights (E, K, ncols) in their own layouts:
//   gate/up: h = bf16(silu(A Wg) * (A Wu)), f32 accumulators, rounded once
//            (where JAX rounds h); no f32 (N, F) tensor reaches memory;
//   down:    y = bf16(h Wd), its f32 accumulator rounded once (where JAX
//            rounds the expert output).
// A third, small kernel combines each token's k slot outputs by their gates
// (moe_combine below).
//
// Bound on the H100: 2 N K ncols FLOPs a product at 989 TFLOP/s in bf16; at
// OLMoE's 131,072 slots a layer (D 2048, F 1024) the three products are
// 1.65e12 FLOPs, 1.67 ms a layer. Every tile is well above the ridge
// (128 x 256 outputs over K: 85 FLOPs a byte of A and B from L2, which
// leaves the loads from L2, not HBM, as the mainloop's limit).
//
// Design: a persistent kernel, one CTA per SM, walks the tiles in a static
// stride (tile t, t + grid, ...). No host knows the group sizes: each CTA
// reads the E + 1 offsets and builds the tile table in shared memory (expert
// e owns ceil(count / 128) row tiles from offsets[e]; a row tile is found by
// a binary search over their prefix). A tile is 128 rows of one expert by
// two 128-column B tiles (gate and up at the same columns, or two adjacent
// column blocks of Wd); its last rows may belong to the next expert or lie
// past N (TMA fills zeros) and are computed but never stored. Three
// warpgroups: a producer warp issues TMA loads (A: 128 x 64 K-major; B:
// 64 x 64-column boxes of the (E, K, ncols) weights, MN-major, both with the
// 128-byte swizzle) into a ring of 48 KB stages behind full/empty mbarriers
// (4 stages for gate/up, 3 for down, whose staged outputs are twice as
// large); two consumer warpgroups, 64 rows each, run wgmma m64n128k16
// (bf16 in, f32 accumulate; B read transposed from its N-major tile) into two
// accumulators of 64 floats a thread, keeping one wgmma group in flight. The
// epilogue of a warpgroup whose 64 rows all belong to the tile's expert is
// staged in shared memory in the swizzled layout and stored by the TMA,
// which runs on while the next tile's products start (timed on the card,
// the register-to-global stores it replaced left down at 45% of the peak
// and gate/up at 61%); the expert's last, partial rows are stored from
// registers with rows past the expert, N or ncols masked. K past the end is
// zero-filled, so any K and ncols that are multiples of 8 work.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;                       // rows of a tile
constexpr int BN = 128;                       // columns of one B tile
constexpr int BK = 64;                        // K of a stage: one 128-byte row of bf16
constexpr int MAX_E = 128;
constexpr int THREADS = 384;                  // 2 consumer warpgroups + 1 producer
constexpr int CONSUMER_WARPS = 8;
constexpr int A_BYTES = BM * BK * 2;          // 16 KB
constexpr int BOX_BYTES = BK * 64 * 2;        // one 64 x 64 box (B in, or out), 8 KB
constexpr int B_BYTES = 2 * BOX_BYTES;        // 16 KB
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;

// gate/up: a ring of 4 stages and 64 x 128 outputs a warpgroup to stage;
// down (K = F is half as deep, the tile twice as wide): 3 stages and
// 64 x 256 outputs a warpgroup
template <bool GATED>
struct Cfg {
  static constexpr int STAGES = GATED ? 4 : 3;
  static constexpr int OUT_BOXES = GATED ? 2 : 4;      // 64-column boxes a warpgroup
  static constexpr int OUT_WG = OUT_BOXES * BOX_BYTES;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES + 2 * OUT_WG +
                                 2 * STAGES * 8 + 2 * (MAX_E + 1) * sizeof(int);
};
// wgmma descriptors (128-byte swizzle): A K-major, 8-row groups 1024 bytes
// apart; B MN-major, 8-k-row groups 1024 bytes apart (SBO) and its two
// 64-column boxes BOX_BYTES apart (LBO)
constexpr uint32_t A_SBO = 1024;
constexpr uint32_t B_LBO = BOX_BYTES;
constexpr uint32_t B_SBO = 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the staged outputs of earlier stores have been read (the buffer is free)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// the generic-proxy writes to shared memory, seen by the TMA (async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the 128 threads of consumer warpgroup wg (barrier 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;   // layout 1: 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (the registers change behind its back)
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32, the warpgroup's fragment) = A (64 x 16, K-major) x
// B (16 x 128, MN-major: imm-trans-b 1) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the expert of row tile r: the last e with tstart[e] <= r (an expert
// without slots has tstart[e] == tstart[e + 1] and is skipped)
__device__ __forceinline__ int find_expert(const int* tstart, int E, int r) {
  int lo = 0, hi = E;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tstart[mid] <= r) lo = mid; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// the warpgroup's 64 x (64 OUT_BOXES) outputs into its staging buffer, as
// 64 x 64 boxes of 128-byte rows with the 128-byte swizzle (the 16-byte
// chunk c of row r at chunk c ^ (r % 8): the 8 rows of a store land in
// distinct banks), the layout the output tensor map stores from
template <bool GATED>
__device__ __forceinline__ void stage_out(uint8_t* buf, const float (&acc0)[64],
                                          const float (&acc1)[64], int warp, int lane) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      const int row = warp * 16 + lane / 4 + 8 * h;
      const int off = (j >> 3) * BOX_BYTES + row * 128 + (((j & 7) ^ (lane >> 2)) << 4) +
                      (lane & 3) * 4;
      if (GATED) {
        *reinterpret_cast<__nv_bfloat162*>(buf + off) = __floats2bfloat162_rn(
            silu(acc0[i]) * acc1[i], silu(acc0[i + 1]) * acc1[i + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(buf + off) =
            __floats2bfloat162_rn(acc0[i], acc0[i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(buf + off + 2 * BOX_BYTES) =
            __floats2bfloat162_rn(acc1[i], acc1[i + 1]);
      }
    }
  }
}

template <bool GATED>
__global__ void __launch_bounds__(THREADS, 1)
moe_grouped_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b0,
                   const __grid_constant__ CUtensorMap tm_b1,
                   const __grid_constant__ CUtensorMap tm_out, bf16* __restrict__ out,
                   const int* __restrict__ offsets, int E, int K, int ncols) {
  using C = Cfg<GATED>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle needs 1024-byte aligned tiles
  uint8_t* staged = smem_raw + (base - raw) + C::STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + 2 * C::OUT_WG);
  uint64_t* empty = full + C::STAGES;
  int* off = reinterpret_cast<int*>(empty + C::STAGES);
  int* tstart = off + MAX_E + 1;

  const int tid = threadIdx.x;
  if (tid <= E) off[tid] = offsets[tid];
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int e = 0; e < E; ++e) {
      tstart[e] = acc;
      acc += (off[e + 1] - off[e] + BM - 1) / BM;
    }
    tstart[E] = acc;
  }
  __syncthreads();
  constexpr int CW = GATED ? BN : 2 * BN;      // output columns of a tile
  const int nt = (ncols + CW - 1) / CW;
  const int tiles = tstart[E] * nt;
  const int kblocks = (K + BK - 1) / BK;

  if (tid >= 2 * 128) {
    // ---- producer warpgroup: one thread keeps the ring's TMA loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 2 * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int r = t / nt, c = t % nt;
        const int e = find_expert(tstart, E, r);
        const int row0 = off[e] + (r - tstart[e]) * BM;
        const int col0 = c * CW, col1 = GATED ? col0 : col0 + BN;
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          const uint32_t bar = smem_u32(&full[stage]);
          mbar_expect_tx(bar, STAGE_BYTES);
          const uint32_t dst = base + stage * STAGE_BYTES;
          const int k0 = kb * BK;
          tma_2d(dst, &tm_a, k0, row0, bar);
          tma_3d(dst + A_BYTES, &tm_b0, col0, k0, e, bar);
          tma_3d(dst + A_BYTES + BOX_BYTES, &tm_b0, col0 + 64, k0, e, bar);
          tma_3d(dst + A_BYTES + B_BYTES, &tm_b1, col1, k0, e, bar);
          tma_3d(dst + A_BYTES + B_BYTES + BOX_BYTES, &tm_b1, col1 + 64, k0, e, bar);
          if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: rows wg * 64 .. + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid / 128, lt = tid % 128, warp = lt / 32, lane = tid % 32;
    uint8_t* buf = staged + wg * C::OUT_WG;
    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int r = t / nt, c = t % nt;
      const int e = find_expert(tstart, E, r);
      const int row0 = off[e] + (r - tstart[e]) * BM;
      const int row_end = off[e + 1];
      const int col0 = c * CW;
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(smem_u32(&full[stage]), phase);
        const uint32_t st = base + stage * STAGE_BYTES;
        const uint32_t a = st + wg * (64 * 128);
        const uint32_t b0 = st + A_BYTES, b1 = b0 + B_BYTES;
        fence_acc(acc0);
        fence_acc(acc1);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
          const int scale = (kb > 0 || ks > 0) ? 1 : 0;
          const uint64_t da = desc(a + ks * 32, 16, A_SBO);
          wgmma128(acc0, da, desc(b0 + ks * 16 * 128, B_LBO, B_SBO), scale);
          wgmma128(acc1, da, desc(b1 + ks * 16 * 128, B_LBO, B_SBO), scale);
        }
        wgmma_commit();
        fence_acc(acc0);
        fence_acc(acc1);
        wgmma_wait<1>();               // the previous stage's products are done
        if (kb > 0 && lane == 0) mbar_arrive(smem_u32(&empty[prev]));
        prev = stage;
        if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_acc(acc0);
      fence_acc(acc1);
      if (lane == 0) mbar_arrive(smem_u32(&empty[prev]));

      const int wrow0 = row0 + wg * 64;
      if (wrow0 + 64 <= row_end) {
        // the warpgroup's 64 rows are all its expert's: stage them and let
        // the TMA store them (columns past ncols and rows past N are
        // clipped) while the next tile's products run
        if (lt == 0) bulk_wait_read();
        wg_sync(wg);
        stage_out<GATED>(buf, acc0, acc1, warp, lane);
        fence_async_shared();
        wg_sync(wg);
        if (lt == 0) {
#pragma unroll
          for (int b = 0; b < C::OUT_BOXES; ++b)
            tma_store_2d(&tm_out, smem_u32(buf) + b * BOX_BYTES, col0 + b * 64, wrow0);
          bulk_commit();
        }
        continue;
      }
      // the expert's last rows: store from registers, rows past row_end
      // (the next expert's, or past N) and columns past ncols masked.
      // Thread (warp, lane) holds rows warp * 16 + lane / 4 (+ 8) of its
      // 64, columns 8 j + 2 (lane % 4) (+ 1) of each 8-column chunk j
      const int rbase = wrow0 + warp * 16 + lane / 4;
      const int cbase = col0 + (lane % 4) * 2;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rbase + h * 8;
          if (row >= row_end) continue;
          bf16* o = out + (size_t)row * ncols;
          const int i = 4 * j + 2 * h;
          const int col = cbase + 8 * j;
          if (GATED) {
            if (col < ncols)
              *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(
                  silu(acc0[i]) * acc1[i], silu(acc0[i + 1]) * acc1[i + 1]);
          } else {
            if (col < ncols)
              *reinterpret_cast<__nv_bfloat162*>(o + col) =
                  __floats2bfloat162_rn(acc0[i], acc0[i + 1]);
            if (col + BN < ncols)
              *reinterpret_cast<__nv_bfloat162*>(o + col + BN) =
                  __floats2bfloat162_rn(acc1[i], acc1[i + 1]);
          }
        }
      }
    }
    if (lt == 0) bulk_wait_all();
  }
}

// The combine: out[t] = bf16(sum over j in 0..k-1, in that order from 0, of
// fl(gate[t, j] * y[inv[t k + j]])) in f32 (no fused multiply-add: each
// product rounds, as the plain version's does). A thread owns 8 columns
// of one token (16-byte loads and store); memory-bound: k rows of y read
// once, one row written.
__global__ void __launch_bounds__(256)
moe_combine_kernel(const bf16* __restrict__ y, const long long* __restrict__ inv,
                   const float* __restrict__ gates, bf16* __restrict__ out, int T, int k, int D) {
  const int chunks = D / 8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)T * chunks) return;
  const long long t = i / chunks;
  const int c = (int)(i % chunks) * 8;
  float acc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = 0.f;
  for (int j = 0; j < k; ++j) {
    const float g = gates[t * k + j];
    const uint4 v = *reinterpret_cast<const uint4*>(y + inv[t * k + j] * D + c);
    const bf16* b = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(g, __bfloat162float(b[q])));
  }
  uint4 o;
  bf16* ob = reinterpret_cast<bf16*>(&o);
#pragma unroll
  for (int q = 0; q < 8; ++q) ob[q] = __float2bfloat16_rn(acc[q]);
  *reinterpret_cast<uint4*>(out + t * D + c) = o;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched by the runtime's entry-point query (the
// library links no libcuda)
EncodeTiled encoder() {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load();
  if (f) return f;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t err =
      cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
  if (err != cudaSuccess || q != cudaDriverEntryPointSuccess || !p) return nullptr;
  f = reinterpret_cast<EncodeTiled>(p);
  fn.store(f);
  return f;
}

// a bf16 tensor map with the 128-byte swizzle; zeros outside the tensor
bool encode(CUtensorMap* map, EncodeTiled fn, const void* ptr, cuuint32_t rank,
            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
            box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// gated = 1: out (rows, ncols) = bf16(silu(a w0[e]) * (a w1[e])) for the rows
// of expert e, w0 = w_gate and w1 = w_up (E, K, ncols); gated = 0: out =
// bf16(a w0[e]), w0 = w1 = w_down. a (rows, K) bf16 sorted by expert,
// offsets (E + 1,) int32 on the device. K and ncols multiples of 8, E <= 128.
extern "C" int moe_grouped_gemm(int gated, const void* a, const void* w0, const void* w1,
                                void* out, const int* offsets, int rows, int K, int ncols, int E,
                                cudaStream_t stream) {
  if (rows < 0 || K < 8 || K % 8 || ncols < 8 || ncols % 8 || E < 1 || E > MAX_E)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const EncodeTiled fn = encoder();
  if (!fn) return cudaErrorNotSupported;
  CUtensorMap tm_a, tm_b0, tm_b1, tm_out;
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t a_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t a_box[2] = {BK, BM};
  const cuuint64_t b_dims[3] = {(cuuint64_t)ncols, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t b_strides[2] = {(cuuint64_t)ncols * 2, (cuuint64_t)K * ncols * 2};
  const cuuint32_t b_box[3] = {64, BK, 1};
  const cuuint64_t o_dims[2] = {(cuuint64_t)ncols, (cuuint64_t)rows};
  const cuuint64_t o_strides[1] = {(cuuint64_t)ncols * 2};
  const cuuint32_t o_box[2] = {64, 64};
  if (!encode(&tm_a, fn, a, 2, a_dims, a_strides, a_box) ||
      !encode(&tm_b0, fn, w0, 3, b_dims, b_strides, b_box) ||
      !encode(&tm_b1, fn, w1, 3, b_dims, b_strides, b_box) ||
      !encode(&tm_out, fn, out, 2, o_dims, o_strides, o_box))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int cw = gated ? BN : 2 * BN;
  const long long upper = ((long long)(rows + BM - 1) / BM + (rows < E ? rows : E)) *
                          ((ncols + cw - 1) / cw);
  const int grid = (int)(upper < sms ? upper : sms);
  if (gated) {
    err = repro_attn::allow_smem<moe_grouped_kernel<true>>(Cfg<true>::SMEM);
    if (err != cudaSuccess) return err;
    moe_grouped_kernel<true><<<grid, THREADS, Cfg<true>::SMEM, stream>>>(
        tm_a, tm_b0, tm_b1, tm_out, static_cast<bf16*>(out), offsets, E, K, ncols);
  } else {
    err = repro_attn::allow_smem<moe_grouped_kernel<false>>(Cfg<false>::SMEM);
    if (err != cudaSuccess) return err;
    moe_grouped_kernel<false><<<grid, THREADS, Cfg<false>::SMEM, stream>>>(
        tm_a, tm_b0, tm_b1, tm_out, static_cast<bf16*>(out), offsets, E, K, ncols);
  }
  return cudaGetLastError();
}

// out (T, D) bf16 = the gate-weighted sum of each token's k slot outputs,
// y (N, D) bf16 in expert order, inv (T k,) int64 each flat slot's row of
// y, gates (T, k) f32. D a multiple of 8.
extern "C" int moe_combine(const void* y, const long long* inv, const float* gates, void* out,
                           int T, int k, int D, cudaStream_t stream) {
  if (T < 0 || k < 1 || D < 8 || D % 8) return cudaErrorInvalidValue;
  const long long threads = (long long)T * (D / 8);
  if (threads == 0) return cudaSuccess;
  moe_combine_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(y), inv, gates, static_cast<bf16*>(out), T, k, D);
  return cudaGetLastError();
}
