// Centroid routing for the IVF two-level store read (level 1).
//
// Replaces src/repro/kernels/memory_ivf.py::ivf_route_batch_padded_pallas
// (body _route_batch_kernel) and its B=1 wrapper ivf_route_padded_pallas.
// Same function: B queries against the (Pp, Ep) f32 centroid plane;
// centroids lacking any bit of `required` in the (Pp, 1) int32 mask plane
// (unseeded clusters, padding rows) score -2.0; each query keeps the top
// n_probe centroid rows by (score descending, row ascending), IEEE compares
// (so +0.0 == -0.0 and only the row decides between them).
//
// Bound on the H100: the plane is small (P = 1024 clusters x 384 lanes,
// 1.6 MB, at a 65536-entry store), so the bytes bound is under 1 us and
// the launch and the per-query selection set the time.
//
// Design: one CTA of 32 warps per query walks the plane in chunks of CH
// rows. Warps dot whole rows (float4 loads, plain f32 FMA, no TF32) into shared
// memory beside the running best n_probe, and the chunk merges with them
// in shared memory: each candidate's place is the number of candidates
// before it in the (score desc, row asc) order, so one pass of compares
// writes the new best n_probe sorted. That is the TPU kernel's sequential
// accumulator, which suits a single CTA; the merge computes what the
// TPU's n_probe selection rounds compute (the top n of a union of
// candidates with distinct rows under a strict total order), in two
// barriers a chunk instead of one per round. One launch, no candidate
// buffer in device memory.
#include <cuda_runtime.h>

namespace {

constexpr int CH = 256;       // plane rows per chunk
constexpr int MAXK = 1024;    // n_probe <= the kernel block (DEFAULT_BLOCK_C)
constexpr int WARPS = 32;     // each warp's rows are a chain of dependent
                              // loads and a reduction: more warps, more rows
                              // in flight
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ bool better(float s, int r, float bs, int br) {
  return s > bs || (s == bs && r < br);
}

__global__ void __launch_bounds__(THREADS)
route_kernel(const float* __restrict__ cent, const float* __restrict__ qs,
             const int* __restrict__ cmask, int Pp, int Ep, int n_probe, int required,
             float* __restrict__ out_s, int* __restrict__ out_r) {
  __shared__ float cs[MAXK + CH];
  __shared__ int cr[MAXK + CH];
  __shared__ float ns[MAXK];
  __shared__ int nr[MAXK];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* q = qs + (size_t)b * Ep;
  int n_acc = 0;

  for (int c0 = 0; c0 < Pp; c0 += CH) {
    const int nc = min(CH, Pp - c0);
    for (int rr = warp; rr < nc; rr += WARPS) {
      const float* crow = cent + (size_t)(c0 + rr) * Ep;
      float acc = 0.f;
      for (int e = lane * 4; e < Ep; e += 128) {
        const float4 m = *reinterpret_cast<const float4*>(crow + e);
        const float4 x = __ldg(reinterpret_cast<const float4*>(q + e));
        acc = fmaf(m.x, x.x, acc);
        acc = fmaf(m.y, x.y, acc);
        acc = fmaf(m.z, x.z, acc);
        acc = fmaf(m.w, x.w, acc);
      }
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        const bool seeded = (cmask[c0 + rr] & required) == required;
        cs[n_acc + rr] = seeded ? acc : -2.0f;
        cr[n_acc + rr] = c0 + rr;
      }
    }
    __syncthreads();
    const int n = n_acc + nc;
    const int keep = min(n_probe, n);
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const float s = cs[i];
      const int r = cr[i];
      int place = 0;
      for (int j = 0; j < n; ++j) place += better(cs[j], cr[j], s, r);
      if (place < keep) { ns[place] = s; nr[place] = r; }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < keep; i += THREADS) { cs[i] = ns[i]; cr[i] = nr[i]; }
    n_acc = keep;
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n_probe; i += THREADS) {
    out_s[(size_t)b * n_probe + i] = cs[i];
    out_r[(size_t)b * n_probe + i] = cr[i];
  }
}

}  // namespace

// cent (Pp, Ep) f32, qs (B, Ep) f32 (lane-padded), cmask (Pp,) int32;
// outputs scores (B, n_probe) f32 and centroid rows (B, n_probe) int32.
extern "C" int ivf_route_batch_padded(const float* cent, const float* qs, const int* cmask,
                                      int Pp, int Ep, int B, int n_probe, int required,
                                      float* out_s, int* out_r, cudaStream_t stream) {
  if (Ep % 4 != 0 || B < 1 || n_probe < 1 || n_probe > Pp || n_probe > MAXK)
    return cudaErrorInvalidValue;
  route_kernel<<<B, THREADS, 0, stream>>>(cent, qs, cmask, Pp, Ep, n_probe, required, out_s,
                                          out_r);
  return cudaGetLastError();
}
