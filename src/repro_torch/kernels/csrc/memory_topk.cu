// Masked multi-query top-k over the padded guide store (the RAR store read),
// one launch for every k.
//
// Replaces src/repro/kernels/memory_topk.py::memory_topk_batch_padded_pallas
// (body _topk_batch_kernel, merge _select_topk) and its B=1 wrapper
// memory_topk_padded_pallas. Same function: B queries against a (Cp, Ep)
// f32 store; rows lacking any bit of `required` score -2.0; each query
// keeps the top-k rows by (sim descending, row ascending), IEEE compares
// (so +0.0 == -0.0 and only the row decides between them).
//
// Bound on the H100: the main path reads the 4096 x 384 store (6.3 MB,
// 1.9 us at 3.35 TB/s; 50 M FMAs at B=32, 1.5 us at 67 TFLOP/s), so
// latency and the launch decide; at C=65536 the store read (30 us) and
// the FMAs (24 us at B=32) nearly balance.
//
// Design: the scan core of store_scan.cuh, one HBM pass for all queries:
//   * k = 1 (the main path's retrieval_k) takes its key mode, unseeded:
//     the largest (sim, row) key per query, one atomicMax per query and
//     warp, unpacked by the last CTA (a best sim of -0.0 comes back as
//     +0.0, equal under IEEE compares);
//   * k >= 2 takes its list mode: each tile's sorted top-k by selection
//     rounds in shared memory, then merges by k rounds over list heads:
//     each CTA walking several tiles merges its own tiles' lists, and the
//     last CTA merges those (or, with one tile a CTA, the tiles' lists).
//     The top-k of a union is the top-k of the parts' top-ks under a strict
//     total order, so the result equals one global selection, at any store
//     size. Consumed and absent candidates are -inf (never
//     selected while a real row is left); the reference consumes to -3.0,
//     which differs only if a view holds sims below -3.0 (impossible for
//     the store's unit-or-zero rows and unit queries).
#include "store_scan.cuh"

namespace {

template <class C, bool LISTS>
__global__ void __launch_bounds__(C::THREADS, 1) topk_scan_kernel(const ScanArgs a) {
  scan_body<C, LISTS>(a);
}

template <class C>
cudaError_t run(const ScanArgs& a, cudaStream_t stream) {
  if (a.k == 1) return launch<C, false, topk_scan_kernel<C, false>>(a, stream);
  return launch<C, true, topk_scan_kernel<C, true>>(a, stream);
}

}  // namespace

// mem (Cp, Ep) f32; qs (B, E) f32 with E % 4 == 0 and E <= Ep; both
// 16-byte aligned; mask (Cp,) int32. state holds B + 1 64-bit words, zero
// before the first launch (B keys, then the ticket); every launch leaves
// them zero. For k >= 2, cand_s/cand_r hold `capacity` entries: B * k a
// tile (32-row tiles below WIDE_MIN_ROWS rows, else 256), and when the
// grid is smaller than the tile count B * k a CTA more from the next
// 4-entry boundary, and 3 spare. Outputs (B, k).
extern "C" int memory_topk_batch_padded(const float* mem, const float* qs, const int* mask,
                                        int Cp, int Ep, int E, int B, int k, int required,
                                        unsigned long long* state, float* cand_s, int* cand_r,
                                        int capacity, float* out_s, int* out_r,
                                        cudaStream_t stream) {
  ScanArgs a{};
  a.mem = mem; a.qs = qs; a.mask = mask;
  a.Cp = Cp; a.Ep = Ep; a.E = E; a.B = B; a.required = required;
  a.k = k;
  a.seeded = 0;
  a.keys = state;
  a.ticket = reinterpret_cast<unsigned int*>(state + B);
  a.cand_s = cand_s; a.cand_r = cand_r; a.capacity = capacity;
  a.out_s = out_s; a.out_r = out_r;
  if (!valid_args(a) || k > Cp || (k > 1 && (cand_s == nullptr || cand_r == nullptr)))
    return cudaErrorInvalidValue;
  const bool wide = Cp >= WIDE_MIN_ROWS;
  if (B == 1) return wide ? run<Wide1>(a, stream) : run<Narrow1>(a, stream);
  if (B <= 8 || Ep > 512) return wide ? run<Wide8>(a, stream) : run<Narrow8>(a, stream);
  return wide ? run<Wide32>(a, stream) : run<Narrow32>(a, stream);
}
