#!/usr/bin/env python3
"""Time variants of the guide-store scan on one card: a tuning aid for
``src/repro_torch/kernels/csrc/store_scan.cuh`` (the core of
``memory_top1.cu`` and ``memory_topk.cu``).

    python3 scripts/store_scan_sweep.py [variant ...]

Each variant is the committed sources with textual substitutions in
``store_scan.cuh`` (``VARIANTS``), built by ``nvcc`` into a library of its
own (all variants compile in parallel; ``-Xptxas -v`` of the base build,
registers and spills a kernel, is printed first): design alternatives, and
timing-only variants that leave part of the work out (their results are
wrong; they say what the part costs). At the store shapes of the main path
(C = 4096 and 65536 rows of 384 lanes; B = 1, 8, 32; top-k at k = 1 and 4)
every variant is compared with the plain version (rows exact, max |error|
of the sims printed) and timed by its device time a call
(``torch.profiler``, the mean over 50 calls), beside the PyTorch library
call's. The output is one line per (variant, kernel, shape), the SM clock
and the card's name and power limit; it needs one CUDA card and no JAX.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

_FMA4 = ("            part[r][q] = fmaf(m[r].x, x.x, part[r][q]);\n"
         "            part[r][q] = fmaf(m[r].y, x.y, part[r][q]);\n"
         "            part[r][q] = fmaf(m[r].z, x.z, part[r][q]);\n"
         "            part[r][q] = fmaf(m[r].w, x.w, part[r][q]);\n")
_W32 = "using Wide32 = Cfg<32, 4, 8, 2, 4, 32, 3>;"
_N32 = "using Narrow32 = Cfg<8, 4, 2, 1, 4, 96, 5>;"
VARIANTS = {  # name: [(text, replacement), ...] in store_scan.cuh
    "base": [],
    # design alternatives, each with correct results
    "wide/lanes8x4": [(_W32, "using Wide32 = Cfg<8, 4, 8, 8, 1, 32, 3>;")],
    "wide/kc64x2": [(_W32, "using Wide32 = Cfg<32, 4, 8, 2, 4, 64, 2>;")],
    "wide/8x4": [(_W32, "using Wide32 = Cfg<32, 8, 4, 1, 8, 32, 3>;")],
    # 512-row tiles: too large for list mode's shared memory (refused)
    "wide/8x8-512rows": [(_W32, "using Wide32 = Cfg<32, 8, 8, 2, 4, 32, 2>;")],
    "wide/8x4-512rows": [(_W32, "using Wide32 = Cfg<32, 8, 4, 2, 8, 32, 2>;")],
    "narrow/lane-row": [(_N32, "using Narrow32 = Cfg<32, 1, 8, 1, 4, 96, 5>;")],
    "narrow/kc96x4": [(_N32, "using Narrow32 = Cfg<8, 4, 2, 1, 4, 96, 4>;")],
    # timing only, wrong results: what a part costs when it is left out
    "-3/4fma": [(_FMA4, "            part[r][q] = fmaf(m[r].x, x.x, "
                        "part[r][q]);\n")],
    "-qload": [("          const float4 x = *reinterpret_cast<const float4*>(qb + q * "
                "C::LQ * ek + kk);",
                "          const float4 x = make_float4(m[0].y, m[0].x, m[0].w, "
                "m[0].z);")],
    "-mload": [("          m[r] = *reinterpret_cast<const float4*>(st + r * C::LR * "
                "C::LD + kk);",
                "          m[r] = make_float4(1.f + r, (float)kk, 0.5f, 0.25f);")],
    "-merge-copies": [("      cp_async16(ss + 4 * i, a.cand_s + o4 + 4 * i, true);\n"
                       "      cp_async16(sr + 4 * i, a.cand_r + o4 + 4 * i, true);\n",
                       "")],
    "-merge-rounds": [("    merge_batch<C, false>(a, ss + (o - o4), sr + (o - o4), nb, "
                       "b0, head);", "")],
    "-loop": [("    for (int g = 0; g < ns; ++g) {",
               "    for (int g = 0; g < 0; ++g) {")],
    "-ticket": [("  // the last CTA to finish completes the read and resets the "
                 "workspace\n", "  return;\n")],
    "-all": [("  for (int q0 = 0; q0 < a.B; q0 += C::QB) {\n    const int nq",
              "  if (a.B > 0) return;\n  for (int q0 = 0; q0 < a.B; q0 += "
              "C::QB) {\n    const int nq")],
}
SOURCES = ("memory_top1.cu", "memory_topk.cu")
ITERS = 50


def build_variants(build, csrc, names):
    """{name: library path} of every variant, compiled in parallel; the
    base build's ptxas report is printed."""
    from repro_torch.kernels import _build
    nvcc = _build._nvcc()
    procs = {}
    for name in names:
        d = Path(tempfile.mkdtemp(dir=build, prefix=name.replace("/", "_")))
        shutil.copy(csrc / "attention_common.cuh", d)
        src = (csrc / "store_scan.cuh").read_text()
        for old, new in VARIANTS[name]:
            if src.count(old) != 1:
                raise AssertionError(f"variant {name}: text not once")
            src = src.replace(old, new)
        (d / "store_scan.cuh").write_text(src)
        for f in SOURCES:
            shutil.copy(csrc / f, d)
        lib = d / "libvariant.so"
        cmd = [nvcc, *_build.FLAGS, "-shared", "-o", str(lib),
               *(str(d / f) for f in SOURCES)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, p) in procs.items():
        out = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{out}")
        if name == "base":
            for line in out.splitlines():
                if "registers" in line or "spill" in line or \
                        "Compiling entry" in line:
                    print(f"ptxas {line.strip()}", flush=True)
        libs[name] = lib
    return libs


def load(path):
    from repro_torch.kernels import _build
    lib = ctypes.CDLL(str(path))
    for fn in ("memory_top1_batch_padded", "memory_topk_batch_padded"):
        getattr(lib, fn).argtypes = list(_build._SIGNATURES[fn])
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main(argv) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("store_scan_sweep: no CUDA card visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import memory_topk as mt

    names = ["base"] + [n for n in argv if n != "base"] if argv else \
        list(VARIANTS)
    print(f"card: {chip_smoke.card_line()}; torch {torch.__version__}",
          flush=True)
    build = ROOT / "build" / "sweep"
    build.mkdir(parents=True, exist_ok=True)
    libs = build_variants(build, _build.CSRC, names)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    torch.cuda._sleep(1_000_000)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    print(f"SM clock from a 1e7-cycle spin: "
          f"{1e7 / start.elapsed_time(end) / 1e6:.3f} GHz", flush=True)
    rng = np.random.default_rng(0)
    for C in (4096, 65536):
        mem = rng.normal(size=(C, 384)).astype(np.float32)
        mem /= np.linalg.norm(mem, axis=1, keepdims=True)
        mem[C // 2] = mem[C - 1] = mem[C // 3]
        bits = (rng.random(C) < 0.7).astype(np.int32) * mt.MASK_VALID
        memp, maskp = (t.to(dev) for t in mt.to_padded_layout(
            torch.from_numpy(mem), torch.from_numpy(bits)))
        valid = (maskp[:, 0] & 1) == 1
        for B in (1, 8, 32):
            qs = rng.normal(size=(B, 384)).astype(np.float32)
            qs /= np.linalg.norm(qs, axis=1, keepdims=True)
            qs[0] = mem[C // 3]
            qs = torch.from_numpy(qs).to(dev)
            cases = [("top1", None), ("topk", 1)] + \
                ([("topk", 4)] if B == 32 else [])
            for kind, k in cases:
                if kind == "top1":
                    def kernel():
                        return mt.memory_top1_batch_padded_cuda(memp, qs,
                                                                maskp)
                    want = mt.memory_top1_batch_padded_plain(memp, qs, maskp)

                    def lib():
                        return torch.argmax(torch.where(
                            valid[None], qs @ memp.T, -2.0), dim=1)
                else:
                    def kernel():
                        return mt.memory_topk_batch_padded_cuda(memp, qs,
                                                                maskp, k)
                    want = mt.memory_topk_batch_padded_plain(memp, qs, maskp,
                                                             k)

                    def lib():
                        return torch.topk(torch.where(
                            valid[None], qs @ memp.T, -2.0), k, dim=1)
                lib_us, _ = chip_smoke.device_ms(torch, lib, "sweep_lib",
                                                 ITERS)
                for name, path in libs.items():
                    _build._lib = load(path)
                    mt._states.clear()
                    mt._lists.clear()
                    try:
                        got = kernel()
                    except RuntimeError as err:     # a refused launch
                        print(f"{kind} {name:14s} C={C} B={B}: {err}",
                              flush=True)
                        continue
                    torch.cuda.synchronize()
                    rows_ok = torch.equal(got[1], want[1])
                    err = (got[0] - want[0]).abs().max().item()
                    us, _ = chip_smoke.device_ms(torch, kernel, "sweep_scan",
                                                 ITERS)
                    print(f"{kind} {name:14s} C={C} B={B}"
                          + ("" if k is None else f" k={k}")
                          + f": device {us * 1e3:.2f} us (library "
                          f"{lib_us * 1e3:.2f} us), rows "
                          f"{'exact' if rows_ok else 'DIFFER'}, "
                          f"max_abs_err {err:.3e}", flush=True)
    _build._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
