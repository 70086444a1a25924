// The candidate read of the IVF two-level store read (level 2), with its
// packed-meta epilogue, one launch for the whole batch.
//
// The counterpart of the body of src/repro/core/memory_ivf.py::
// _ivf_topk_batch_jit after its route (the JAX package leaves it to XLA,
// which fuses it; there is no Pallas kernel). Given each query's routed
// probes (scores, centroid rows), it expands them into n_probe x M
// candidate slots of the (P, M) member buckets, drops a candidate whose
// probe is dead (score <= -2.0), whose bucket slot is empty (< 0) or whose
// assign[slot] no longer names the probed cluster (a stale member), and
// scores the rest against the store: a dropped candidate gets sim -2.0 and
// key 2^30 + its position p * M + m, a kept one lacking `required` sim
// -2.0 and key slot, a kept one its dot and key slot. Each query keeps
// the top k by (sim descending, key ascending). A dropped winner comes
// back as (-2.0, 2^30): the reference's selection rounds
// (ref._topk_select) return their 2^30 sentinel for every round that lands
// on the dropped candidates. Each winner's packed meta [index, has_guide,
// hard, added_at, guide...] is written as memory.pack_meta_parts writes
// it, the index being the key clamped into the store's C slots.
//
// The store may be sharded (repro_torch/core/memory_sharded.py): with
// cs > 0, slot g's row and mask bits sit at physical row
// (g / cs) * csp + g % cs (the JAX package's _phys_rows), while assign,
// hard, added_at and guide stay indexed by slot; cs = 0 reads row g.
//
// Bound on the H100: the rows it reads, as many as the probed buckets
// keep. At 1024 clusters, 4 probes and buckets of 256 (Phase I2), a query
// has 1024 candidate slots and ~260 kept rows: ~0.4 MB of rows a query,
// 12.9 MB at B=32 (3.9 us at 3.35 TB/s; full buckets would be 50.3 MB).
// A tile's candidates resolve through four dependent loads (probe,
// cluster, bucket slot, assign) before its rows can be read, so latency
// sets the time unless many tiles are in flight.
//
// Design: one CTA of 128 threads for each (query, tile of 32 candidates),
// B x tiles CTAs (1024 at B=32), small enough in shared memory that every
// SM holds eight, so a batch's tiles are in flight together.
//   * Warp 0 resolves its tile's candidates (probe -> cluster -> bucket
//     slot -> assign check, the mask bits) while the other warps stream the
//     query into shared memory (cp.async, zero past E); a ballot compacts
//     the kept candidates, so a tile reads only the rows it keeps (about a
//     quarter of the slots at I2, whose buckets are a quarter full) and a
//     dropped candidate's row is never read.
//   * The kept rows, 16 at a time, are read by slot with 16-byte cp.async
//     into shared memory, all in flight together, and every dot is summed
//     in the scan core's order (ivf_common.cuh, tile_dots), so a row scores
//     bit for bit as the exact scan scores it.
//   * Selection: for k = 1 (the RAR default retrieval_k) the tile's best
//     64-bit key (order-preserving sim bits over 0xFFFFFFFF - key) goes to
//     one atomicMax per query; for k >= 2 warp 0 sorts the tile's 32 keys
//     with shuffles and writes the top min(k, 32) to a (B, tiles, .)
//     workspace.
//   * The last CTA of a query to take the query's ticket (B tickets, so the
//     queries finish in parallel) unpacks the key or merges the query's
//     tile lists (merge_lists_by_warp: k rounds over the list heads), writes
//     the sims and the winners' packed meta, and leaves the key and the
//     ticket at zero for the next launch.
#include "ivf_common.cuh"

namespace {

constexpr int KEY_SENTINEL = 1 << 30;
constexpr int MASK_GUIDE_BIT = 2;  // memory_topk.MASK_GUIDE

struct ScanIvfArgs {
  const float* scores;   // (B, n_probe) routed scores
  const int* cids;       // (B, n_probe) routed centroid-plane rows
  const int* cidmap;     // (ps,) plane row -> cluster id
  const int* members;    // (P, M) bucket slots, -1 empty
  const int* assign;     // (C,) slot -> cluster, -1 none
  const float* emb;      // (Cp, Ep) store rows
  const int* mask;       // (Cp,) store bit plane
  const unsigned char* hard;  // (C,) bool
  const int* added_at;   // (C,)
  const int* guide;      // (C, G)
  const float* qs;       // (B, E): rows of E floats, E % 4 == 0, 16-byte aligned
  int ps, P, M, C, G, Ep, E, B, n_probe, k, required;
  int cs, csp;           // sharded geometry; cs = 0: row = slot
  int L, tiles, len;     // candidates and tiles a query; entries a tile's list
  int smem_floats;
  u64* keys;             // k = 1: B keys, 0 between launches
  unsigned int* tickets; // B, 0 between launches
  u64* lists;            // k >= 2: (B, tiles, len)
  float* out_s;          // (B, k)
  int* out_meta;         // (B, k, 4 + G)
};

// Shared memory: the dots' for GROUP rows at a time (ivf_common.cuh: the
// rows, the query, the blocks' sums of one query), then the tile's kept
// candidates' slots, rows, lanes and dots: 27.7 KB at E = 384, so an SM
// holds eight CTAs.
constexpr int GROUP = 16;  // kept rows staged at a time
inline size_t scan_floats(int Ep) {
  return (size_t)GROUP * row_stride(Ep) + Ep + (size_t)GROUP * (n_blocks(Ep) + 1) + 4 * TILE + 4;
}

// The store row of ring slot `slot` (in [0, C)).
__device__ __forceinline__ int store_row(const ScanIvfArgs& a, int slot) {
  return a.cs ? (slot / a.cs) * a.csp + slot % a.cs : slot;
}

__global__ void __launch_bounds__(NTHREADS) ivf_scan_kernel(const ScanIvfArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool last;
  __shared__ int nkept;
  const int ld = row_stride(a.Ep);
  float* rows = smem;
  float* q = rows + GROUP * ld;
  float* parts = q + a.Ep;
  int* kslot = reinterpret_cast<int*>(parts + GROUP * (n_blocks(a.Ep) + 1));  // kept, compacted
  int* kphys = kslot + TILE;
  int* klane = kphys + TILE;
  float* kdot = reinterpret_cast<float*>(klane + TILE);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / a.tiles, t = blockIdx.x % a.tiles;
  const int j = t * TILE + lane;  // warp 0: this lane's candidate

  int slot = -1, bits = 0, at = 0;
  if (warp == 0) {
    int phys = 0;
    if (j < a.L) {
      const int p = j / a.M, m = j % a.M;
      const float score = __ldg(a.scores + (size_t)b * a.n_probe + p);
      const int crow = __ldg(a.cids + (size_t)b * a.n_probe + p);
      const int cid = crow >= 0 && crow < a.ps ? __ldg(a.cidmap + crow) : KEY_SENTINEL;
      const int owner = min(max(cid, 0), a.P - 1);
      const int s = __ldg(a.members + (size_t)owner * a.M + m);
      const int clamped = min(max(s, 0), a.C - 1);
      phys = store_row(a, clamped);
      if (score > -2.0f && s >= 0 && __ldg(a.assign + clamped) == owner) {
        slot = s;
        bits = __ldg(a.mask + phys);
      }
    }
    const unsigned kept = __ballot_sync(0xffffffffu, slot >= 0);  // compact the kept ones
    at = __popc(kept & ((1u << lane) - 1));
    if (slot >= 0) {
      kslot[at] = slot;
      kphys[at] = phys;
      klane[at] = lane;
    }
    if (lane == 0) nkept = __popc(kept);
  } else {
    for (int i = threadIdx.x - 32; i < a.Ep / 4; i += NTHREADS - 32) {
      const int e = 4 * i;
      cp_async16(q + e, e < a.E ? a.qs + (size_t)b * a.E + e : a.qs, e < a.E);
    }
  }
  cp_async_commit();
  __syncthreads();

  // the kept rows, GROUP at a time, read by slot and dotted in the scan
  // core's order; a dropped candidate's row is never read
  const int per_row = a.Ep / 4, n = nkept;
  for (int g = 0; g < n; g += GROUP) {
    const int nr = min(GROUP, n - g);
    for (int i = threadIdx.x; i < nr * per_row; i += NTHREADS) {
      const int r = i / per_row, e = (i % per_row) * 4;
      cp_async16(rows + r * ld + e, a.emb + (size_t)kphys[g + r] * a.Ep + e, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float dot = tile_dots<1>(rows, q, parts, a.Ep, 1, nr);
    if (threadIdx.x < nr) kdot[g + threadIdx.x] = dot;
    __syncthreads();  // the rows are free again
  }
  cp_async_wait<0>();

  if (warp == 0) {
    u64 key = 0ull;  // absent past the query's candidates
    if (j < a.L)
      key = slot >= 0 ? pack((bits & a.required) == a.required ? kdot[at] : -2.0f, slot)
                      : pack(-2.0f, KEY_SENTINEL + j);
    if (a.k == 1) {
      key = warp_max(key);
      if (lane == 0) atomicMax(a.keys + b, key);
    } else {
      key = warp_sort_desc(key);
      if (lane < a.len) a.lists[((size_t)b * a.tiles + t) * a.len + lane] = key;
    }
  }

  // the last CTA of the query completes its read and resets its workspace
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.tickets + b, 1u) == (unsigned)a.tiles - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  u64* out = reinterpret_cast<u64*>(smem);  // the k winners, then the stage
  if (a.k == 1) {
    if (threadIdx.x == 0) out[0] = atomicExch(a.keys + b, 0ull);
    __syncthreads();
  } else {
    merge_lists_by_warp(a.lists + (size_t)b * a.tiles * a.len, 1, a.tiles, a.len, a.k,
                        out + a.k, a.smem_floats / 2 - a.k, out);
  }
  const int W = 4 + a.G;
  for (int i = threadIdx.x; i < a.k * W; i += NTHREADS) {
    const int w = i / W, f = i % W;
    const int id = key_id(out[w]);
    const int idx = min(id, a.C - 1);  // a dropped winner's 2^30 + j clamps to C - 1
    int v;
    if (f == 0) v = idx;
    else if (f == 1)
      v = id < KEY_SENTINEL && (__ldcg(a.mask + store_row(a, idx)) & MASK_GUIDE_BIT) ? 1 : 0;
    else if (f == 2) v = a.hard[idx];
    else if (f == 3) v = a.added_at[idx];
    else v = a.guide[(size_t)idx * a.G + f - 4];
    a.out_meta[((size_t)b * a.k + w) * W + f] = v;
    if (f == 0) a.out_s[(size_t)b * a.k + w] = key_sim(out[w]);
  }
  if (threadIdx.x == 0) a.tickets[b] = 0u;
}

}  // namespace

// scores/cids (B, n_probe) f32/int32 from the route; cidmap (ps,), members
// (P, M), assign (C,) int32; emb (Cp, Ep) f32 with Ep % 4 == 0, mask (Cp,)
// int32, slot g at row g, or at (g / cs) * csp + g % cs when cs > 0 (then
// C % cs == 0, cs <= csp and (C / cs) * csp <= Cp); hard (C,) bool,
// added_at (C,) int32, guide (C, G) int32; qs (B, E) f32 with E % 4 == 0
// and E <= Ep; emb and qs 16-byte aligned. state holds 2 B 64-bit words,
// zero before the first launch (B keys, then B tickets); every launch
// leaves them zero. For k >= 2, lists holds `capacity` 64-bit
// words, at least B * ceil(n_probe * M / 32) * min(k, 32). Outputs sims
// (B, k) f32 and the winners' packed meta (B, k, 4 + G) int32.
extern "C" int ivf_scan_batch(const float* scores, const int* cids, const int* cidmap, int ps,
                              const int* members, int P, int M, const int* assign, int C,
                              const float* emb, const int* mask, int Ep,
                              const unsigned char* hard, const int* added_at, const int* guide,
                              int G, const float* qs, int E, int B, int n_probe, int k,
                              int required, int cs, int csp, u64* state, u64* lists,
                              int capacity, float* out_s, int* out_meta, cudaStream_t stream) {
  ScanIvfArgs a{};
  a.scores = scores; a.cids = cids; a.cidmap = cidmap; a.members = members;
  a.assign = assign; a.emb = emb; a.mask = mask; a.hard = hard; a.added_at = added_at;
  a.guide = guide; a.qs = qs;
  a.ps = ps; a.P = P; a.M = M; a.C = C; a.G = G; a.Ep = Ep; a.E = E; a.B = B;
  a.n_probe = n_probe; a.k = k; a.required = required;
  a.cs = cs; a.csp = csp;
  a.L = n_probe * M;
  a.tiles = (a.L + TILE - 1) / TILE;
  a.len = min(k, TILE);
  a.keys = state;
  a.tickets = reinterpret_cast<unsigned int*>(state + B);
  a.lists = lists;
  a.out_s = out_s; a.out_meta = out_meta;
  const uintptr_t aligned = reinterpret_cast<uintptr_t>(emb) | reinterpret_cast<uintptr_t>(qs);
  if (ps < 1 || P < 1 || M < 1 || C < 1 || G < 0 || B < 1 || n_probe < 1 || k < 1 ||
      k > a.L || cs < 0 || (cs > 0 && (csp < cs || C % cs)) || Ep < 4 || Ep % 4 ||
      Ep > MAX_EP || E < 4 || E % 4 || E > Ep || aligned % 16 || state == nullptr ||
      (long long)B * a.tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (k > 1 && (lists == nullptr || (long long)B * a.tiles * a.len > capacity))
    return cudaErrorInvalidValue;
  // the merge needs room for the winners and a warp's state at least
  const size_t floats = std::max(scan_floats(Ep),
                                 2 * ((size_t)k + a.tiles + (a.tiles + 1) / 2) + 4);
  const size_t bytes = floats * sizeof(float);
  if (bytes > MAX_DYN_SMEM) return cudaErrorInvalidValue;
  int resident = 0;
  const cudaError_t err = prepare<ivf_scan_kernel>(NTHREADS, bytes, &resident);
  if (err != cudaSuccess) return err;
  a.smem_floats = (int)floats;
  ivf_scan_kernel<<<(unsigned)(B * a.tiles), NTHREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}
