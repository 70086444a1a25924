// Masked multi-query top-1 over the padded guide store (memory.query and
// memory.query_batch), one launch and no other device operation.
//
// Replaces src/repro/kernels/memory_topk.py::memory_top1_batch_padded_pallas
// (body _top1_batch_kernel) and ::memory_top1_padded_pallas (body
// _top1_kernel; here the same kernel with one query). Same function: B
// queries against a (Cp, Ep) f32 store; rows lacking any bit of `required`
// score -2.0; each query keeps the max sim, ties to the lowest row. The TPU
// kernel's running best starts at (-2.0, row 0) and moves only on a
// strictly greater sim, so an empty view gives (-2.0, 0); so does this one.
// The compact (C, E) store of ops.memory_top1* comes here as it is (Cp = C,
// Ep = E): the scan takes any row count.
//
// Bound on the H100: at C=65536, E=384, B=32 the store read (100.7 MB,
// 30 us at 3.35 TB/s) and the 805 M FMAs (24 us at 67 TFLOP/s) nearly
// balance; at C=4096 both are under 2 us and latency decides.
//
// Design: the scan core of store_scan.cuh in key mode with the seed: the
// queries staged on chip once a CTA, the store streamed once through a
// cp.async ring, register-tiled f32 FMA dots, each thread's best (sim, row)
// per query as a 64-bit key, one atomicMax per query and warp, and the
// last CTA unpacks the keys and puts them back to 0 (the sim is the row's
// own bits; a sim of -0.0 comes back as +0.0).
#include "store_scan.cuh"

namespace {

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1) top1_scan_kernel(const ScanArgs a) {
  scan_body<C, false>(a);
}

template <class C>
cudaError_t run(const ScanArgs& a, cudaStream_t stream) {
  return launch<C, false, top1_scan_kernel<C>>(a, stream);
}

}  // namespace

// mem (Cp, Ep) f32; qs (B, E) f32 with E % 4 == 0 and E <= Ep; both
// 16-byte aligned; mask (Cp,) int32. state holds B + 1 64-bit words, zero before
// the first launch: B keys, then the ticket; every launch leaves them zero.
// Outputs sims (B,) f32 and rows (B,) int32.
extern "C" int memory_top1_batch_padded(const float* mem, const float* qs, const int* mask,
                                        int Cp, int Ep, int E, int B, int required,
                                        unsigned long long* state, float* out_s, int* out_r,
                                        cudaStream_t stream) {
  ScanArgs a{};
  a.mem = mem; a.qs = qs; a.mask = mask;
  a.Cp = Cp; a.Ep = Ep; a.E = E; a.B = B; a.required = required;
  a.k = 1;
  a.seeded = 1;
  a.keys = state;
  a.ticket = reinterpret_cast<unsigned int*>(state + B);
  a.out_s = out_s; a.out_r = out_r;
  if (!valid_args(a)) return cudaErrorInvalidValue;
  const bool wide = Cp >= WIDE_MIN_ROWS;
  if (B == 1) return wide ? run<Wide1>(a, stream) : run<Narrow1>(a, stream);
  if (B <= 8 || Ep > 512) return wide ? run<Wide8>(a, stream) : run<Narrow8>(a, stream);
  return wide ? run<Wide32>(a, stream) : run<Narrow32>(a, stream);
}
