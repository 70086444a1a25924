#!/usr/bin/env python3
"""Time variants of the two attention kernels on one card: a tuning aid for
``src/repro_torch/kernels/csrc/flash_attention.cu`` and
``decode_attention.cu``.

    python3 scripts/attention_sweep.py

Each variant is the committed sources with one textual substitution
(``VARIANTS``), built by ``nvcc`` into a library of its own (all variants
compile in parallel): design alternatives, and timing-only variants that
leave one phase out (their results are wrong; they say what the phase
costs). At the main path's shapes every variant is compared with the plain
version (max |error| printed) and timed by its device time a call
(``torch.profiler``, the mean over 50 calls), beside SDPA's; decode
variants at MIN_CHUNK 16, 32 and 64. The output is one line per (variant,
shape), the SM clock and the card's name and power limit; it needs one
CUDA card and no JAX.
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

VARIANTS = {  # name: (source, text, replacement); "base" is the source as is
    "base": ("", "", ""),
    # design alternatives, each with correct results
    "flash/p-one-term": (  # P as one bf16 term in P V
        "flash_attention.cu",
        "      for (int dp = 0; dp < HD / 16; ++dp) {\n"
        "        mma16816(o[2 * dp], lo, vf[dp][0], vf[dp][1]);\n"
        "        mma16816(o[2 * dp + 1], lo, vf[dp][2], vf[dp][3]);\n"
        "      }\n", ""),
    "flash/bk32x4": ("flash_attention.cu",
                     "TC_BK = 64;      // keys a tile\nconstexpr int TC_STAGES = 2;",
                     "TC_BK = 32;      // keys a tile\nconstexpr int TC_STAGES = 4;"),
    "flash/bk64x3": ("flash_attention.cu",
                     "TC_BK = 64;      // keys a tile\nconstexpr int TC_STAGES = 2;",
                     "TC_BK = 64;      // keys a tile\nconstexpr int TC_STAGES = 3;"),
    "flash/heavy-first": (  # the q-tiles with the most key tiles launch first
        "flash_attention.cu",
        "const int q0 = blockIdx.x * TC_BQ, h = blockIdx.y, b = blockIdx.z;",
        "const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ, h = blockIdx.y, "
        "b = blockIdx.z;"),
    "decode/stages4": ("decode_attention.cu", "constexpr int STAGES = 2;",
                       "constexpr int STAGES = 4;"),
    "flash/mask-all": (  # every tile takes the per-element mask
        "flash_attention.cu", "k0 + TC_BK <= Sk;  // warp-uniform",
        "k0 + TC_BK <= Sk && false;"),
    # timing only, wrong results: what one phase costs when it is left out
    "flash/-copies": ("flash_attention.cu",
                      "    if (t + TC_STAGES - 1 < t1) stage(t + TC_STAGES - 1);",
                      "    if (false) stage(t + TC_STAGES - 1);"),
    "flash/-s": ("flash_attention.cu",
                 "        mma16816(s[2 * np], qf[kk], kf[np][0], kf[np][1]);\n"
                 "        mma16816(s[2 * np + 1], qf[kk], kf[np][2], kf[np]"
                 "[3]);\n", ""),
    "flash/-mask": ("flash_attention.cu",
                    "          x = key < Sk ? (valid ? x : NEG_INF) : -INFINITY;\n",
                    "          x = valid && key < Sk ? x : x;\n"),
    "flash/-exp": ("flash_attention.cu",
                   "const float p = exp2f(s[nt][e] - m[e >> 1]);",
                   "const float p = s[nt][e] - m[e >> 1];"),
    "flash/-pv": ("flash_attention.cu",
                  "    for (int kk = 0; kk < TC_BK / 16; ++kk) {\n      uint32_t hi",
                  "    for (int kk = 0; kk < 0; ++kk) {\n      uint32_t hi"),
    "decode/-merge": ("decode_attention.cu", "  if (!last) return;\n",
                      "  return;\n"),
}
SOURCES = ("flash_attention.cu", "decode_attention.cu")
ITERS = 50


def build_variants(build, csrc):
    """{name: library path} of every variant (both attention sources, one
    of them changed), compiled in parallel."""
    from repro_torch.kernels import _build
    nvcc = _build._nvcc()
    procs = {}
    for name, (target, old, new) in VARIANTS.items():
        d = Path(tempfile.mkdtemp(dir=build, prefix=name.replace("/", "_")))
        shutil.copy(csrc / "attention_common.cuh", d)
        for f in SOURCES:
            src = (csrc / f).read_text()
            if f == target:
                if src.count(old) != 1:
                    raise AssertionError(f"variant {name}: text not once in "
                                         f"{f}")
                src = src.replace(old, new)
            (d / f).write_text(src)
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
        libs[name] = lib
    return libs


def load(path):
    from repro_torch.kernels import _build
    lib = ctypes.CDLL(str(path))
    for fn in ("flash_attention_fwd", "decode_attention_fwd"):
        getattr(lib, fn).argtypes = list(_build._SIGNATURES[fn])
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("attention_sweep: no CUDA card visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    print(f"card: {chip_smoke.card_line()}; torch {torch.__version__}",
          flush=True)
    build = ROOT / "build" / "sweep"
    build.mkdir(parents=True, exist_ok=True)
    libs = build_variants(build, _build.CSRC)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # the SM clock under this load: a spin of a known cycle count, timed
    torch.cuda._sleep(1_000_000)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    print(f"SM clock from a 1e7-cycle spin: "
          f"{1e7 / start.elapsed_time(end) / 1e6:.3f} GHz", flush=True)
    bf16, f32 = torch.bfloat16, torch.float32
    flash_shapes = [("llama3-8b", 1, Sq, 32, 8, 128, bf16, True)
                    for Sq in (17, 130, 300)]
    flash_shapes += [("llama3-8b", 1, 300, 32, 8, 128, bf16, False),
                     ("rar-strong", 8, 130, 6, 6, 32, f32, True),
                     ("embedder", 32, 16, 4, 4, 32, f32, False)]
    for tag, B, Sq, H, KV, hd, dtype, causal in flash_shapes:
        q, k, v = (rand(B, Sq, n, hd, dtype=dtype) for n in (H, KV, KV))
        want = fa.flash_attention_plain(q, k, v, causal=causal).float()
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa, _ = chip_smoke.device_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True),
            "sweep_sdpa", ITERS)
        for name, path in libs.items():
            if name.startswith("decode/"):
                continue
            _build._lib = load(path)
            got = fa.flash_attention_cuda(q, k, v, causal=causal).float()
            err = (got - want).abs().max().item()
            us, _ = chip_smoke.device_ms(
                torch, lambda: fa.flash_attention_cuda(q, k, v,
                                                       causal=causal),
                "sweep_flash", ITERS)
            print(f"flash {name:18s} {tag} B={B} Sq={Sq} H={H} KV={KV} "
                  f"hd={hd} {str(dtype)[6:]} causal={causal}: device "
                  f"{us * 1e3:.2f} us (SDPA {sdpa * 1e3:.2f} us), "
                  f"max_abs_err {err:.3e}", flush=True)
    min_chunk0 = da.MIN_CHUNK
    for tag, B, M, cl, H, KV, hd, dtype in (
            ("llama3-8b", 1, 308, 301, 32, 8, 128, bf16),
            ("llama3-8b", 1, 1032, 1024, 32, 8, 128, bf16),
            ("llama3-8b", 1, 4104, 4096, 32, 8, 128, bf16),
            ("rar-strong", 8, 132, 131, 6, 6, 32, f32)):
        q = rand(B, H, hd, dtype=dtype)
        k, v = rand(B, M, KV, hd, dtype=dtype), rand(B, M, KV, hd,
                                                     dtype=dtype)
        clt = torch.full((B,), cl, dtype=torch.int32, device=dev)
        want = da.decode_attention_plain(q, k, v, clt).float()
        qt, kt, vt = q[:, :, None], k[:, :cl].transpose(1, 2), \
            v[:, :cl].transpose(1, 2)
        sdpa, _ = chip_smoke.device_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True), "sweep_sdpa", ITERS)
        for name, path in libs.items():
            if name.startswith("flash/"):
                continue
            _build._lib = load(path)
            da._workspaces.clear()  # fresh tickets: "-merge" never resets them
            for min_chunk in (16, 32, 64):
                da.MIN_CHUNK = min_chunk
                chunk, n = da.split(M, 0, B * KV, 132)
                got = da.decode_attention_cuda(q, k, v, clt).float()
                err = (got - want).abs().max().item()
                us, _ = chip_smoke.device_ms(
                    torch, lambda: da.decode_attention_cuda(q, k, v, clt),
                    "sweep_decode", ITERS)
                print(f"decode {name:15s} MIN_CHUNK={min_chunk:3d} ({n:2d} "
                      f"chunks of {chunk:3d}) {tag} B={B} cache_len={cl} "
                      f"H={H} KV={KV} hd={hd} {str(dtype)[6:]}: device "
                      f"{us * 1e3:.2f} us (SDPA {sdpa * 1e3:.2f} us), "
                      f"max_abs_err {err:.3e}", flush=True)
    da.MIN_CHUNK = min_chunk0
    return 0


if __name__ == "__main__":
    sys.exit(main())
