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
// 1.6 MB at a 65536-entry store: 0.47 us at 3.35 TB/s; 25 M FMAs at B=32,
// 0.4 us at 67 TFLOP/s), so latency decides, and the selection: on the
// H100 the store's top-k read run over the plane (its scan core,
// store_scan.cuh) took 13.6 us at B=8 and 676 us at B=32, n_probe=64,
// nearly all of it the single last CTA's serial merge of every query's
// lists.
//
// Design: one CTA of 128 threads for each (group of up to 4 queries, tile
// of 32 plane rows), and the merge spread over the groups in the same
// launch:
//   * The CTA stages its tile's rows (cp.async, 16 bytes a copy) and its
//     queries in shared memory and sums every dot in the scan core's order
//     (ivf_common.cuh, tile_dots), so a centroid scores bit for bit as the
//     plain version scores it. L2 serves each group's read of the plane.
//   * Each warp sorts its query's 32 (score, row) keys with shuffles and
//     writes the tile's top min(n_probe, 32) to a (B, tiles, .) workspace.
//   * The last CTA of a group to take the group's ticket merges the
//     group's lists, a warp a query (merge_lists_by_warp: n_probe rounds
//     over the list heads by shuffles), and writes the n_probe winners of
//     each of its queries; it leaves the ticket at zero.
#include "ivf_common.cuh"

namespace {

constexpr int QG = 4;  // queries a CTA

struct RouteArgs {
  const float* cent;   // (Pp, Ep)
  const float* qs;     // (B, E): rows of E floats, E % 4 == 0, 16-byte aligned
  const int* cmask;    // (Pp,)
  int Pp, Ep, E, B, n, required;
  int tiles, len;      // tiles of the plane; entries a tile's list
  int smem_floats;
  unsigned int* tickets;  // one a group, 0 between launches
  u64* lists;             // (B, tiles, len)
  float* out_s;           // (B, n)
  int* out_r;
};

__global__ void __launch_bounds__(NTHREADS) route_kernel(const RouteArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool last;
  const int ld = row_stride(a.Ep);
  float* rows = smem;
  float* qs = rows + TILE * ld;
  float* parts = qs + QG * a.Ep;
  const int g = blockIdx.x / a.tiles, t = blockIdx.x % a.tiles;
  const int b0 = g * QG, nq = min(QG, a.B - b0), row0 = t * TILE;
  const int nrows = min(TILE, a.Pp - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int per_row = a.Ep / 4, per_q = a.Ep / 4;
  for (int i = threadIdx.x; i < nrows * per_row; i += NTHREADS) {
    const int r = i / per_row, e = (i % per_row) * 4;
    cp_async16(rows + r * ld + e, a.cent + (size_t)(row0 + r) * a.Ep + e, true);
  }
  for (int i = threadIdx.x; i < nq * per_q; i += NTHREADS) {
    const int q = i / per_q, e = (i % per_q) * 4;
    cp_async16(qs + q * a.Ep + e, e < a.E ? a.qs + (size_t)(b0 + q) * a.E + e : a.qs, e < a.E);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const float dot = tile_dots<QG>(rows, qs, parts, a.Ep, nq, nrows);
  if (warp < nq) {  // warp q holds query b0 + q's 32 keys, row `lane`
    const int row = row0 + lane;
    u64 key = 0ull;
    if (lane < nrows)
      key = pack((__ldg(a.cmask + row) & a.required) == a.required ? dot : -2.0f, row);
    key = warp_sort_desc(key);
    if (lane < a.len) a.lists[((size_t)(b0 + warp) * a.tiles + t) * a.len + lane] = key;
  }

  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.tickets + g, 1u) == (unsigned)a.tiles - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  u64* out = reinterpret_cast<u64*>(smem);  // nq * n winners, then the merge's room
  merge_lists_by_warp(a.lists + (size_t)b0 * a.tiles * a.len, nq, a.tiles, a.len, a.n,
                      out + nq * a.n, a.smem_floats / 2 - nq * a.n, out);
  for (int i = threadIdx.x; i < nq * a.n; i += NTHREADS) {
    a.out_s[(size_t)b0 * a.n + i] = key_sim(out[i]);
    a.out_r[(size_t)b0 * a.n + i] = key_id(out[i]);
  }
  if (threadIdx.x == 0) a.tickets[g] = 0u;
}

}  // namespace

// cent (Pp, Ep) f32 with Ep % 4 == 0; qs (B, E) f32 with E % 4 == 0 and
// E <= Ep; both 16-byte aligned; cmask (Pp,) int32. tickets holds
// ceil(B / 4) words, zero before the first launch; every launch leaves them
// zero. lists holds `capacity` 64-bit words, at least B * ceil(Pp / 32) *
// min(n_probe, 32). Outputs scores (B, n_probe) f32 and centroid rows
// (B, n_probe) int32.
extern "C" int ivf_route_batch_padded(const float* cent, const float* qs, const int* cmask,
                                      int Pp, int Ep, int E, int B, int n_probe, int required,
                                      unsigned int* tickets, u64* lists, int capacity,
                                      float* out_s, int* out_r, cudaStream_t stream) {
  RouteArgs a{};
  a.cent = cent; a.qs = qs; a.cmask = cmask;
  a.Pp = Pp; a.Ep = Ep; a.E = E; a.B = B; a.n = n_probe; a.required = required;
  a.tiles = (Pp + TILE - 1) / TILE;
  a.len = min(n_probe, TILE);
  a.tickets = tickets; a.lists = lists; a.out_s = out_s; a.out_r = out_r;
  const uintptr_t aligned = reinterpret_cast<uintptr_t>(cent) | reinterpret_cast<uintptr_t>(qs);
  const long long groups = (B + QG - 1) / QG;
  if (Pp < 1 || B < 1 || n_probe < 1 || n_probe > Pp || Ep < 4 || Ep % 4 || Ep > MAX_EP ||
      E < 4 || E % 4 || E > Ep || aligned % 16 || tickets == nullptr || lists == nullptr ||
      (long long)B * a.tiles * a.len > capacity || groups * a.tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // the merge needs room for the winners and the warps' state at least
  const size_t merge = (size_t)QG * n_probe + QG * (a.tiles + (a.tiles + 1) / 2);
  const size_t floats = std::max(dot_floats(Ep, QG), 2 * merge + 4);
  const size_t bytes = floats * sizeof(float);
  if (bytes > MAX_DYN_SMEM) return cudaErrorInvalidValue;
  int resident = 0;
  const cudaError_t err = prepare<route_kernel>(NTHREADS, bytes, &resident);
  if (err != cudaSuccess) return err;
  a.smem_floats = (int)floats;
  route_kernel<<<(unsigned)(groups * a.tiles), NTHREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}
