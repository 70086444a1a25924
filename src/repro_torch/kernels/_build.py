"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` process (all started together)
to an object for ``sm_90a``; the objects link into one shared library with
a plain C interface, loaded with :mod:`ctypes`. The library lands in
``build/kernels/<hash>/`` at the root of the checkout, keyed on a hash of
the sources and flags, so a fresh checkout builds everything at first use
and later calls reuse it. Nothing here runs at import time: the CPU tests
import every module on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("memory_topk.cu", "memory_top1.cu", "ivf_route.cu",
           "ivf_scan.cu", "flash_attention.cu", "decode_attention.cu",
           "moe_grouped.cu")
HEADERS = ("attention_common.cuh", "store_scan.cuh", "ivf_common.cuh")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ("-std=c++17", "-O3", ARCH, "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

#: guards the wrappers' launch counters (the serve thread and the async
#: shadow drainer launch concurrently) and :data:`STREAM_LAUNCHES`
COUNT_LOCK = threading.Lock()
#: launches by (kernel, CUDA stream handle) since the last reset
STREAM_LAUNCHES: dict[tuple[str, int], int] = {}


def note_stream(kernel: str, stream: int) -> None:
    """Count one launch of ``kernel`` on ``stream``; call under
    :data:`COUNT_LOCK`, beside the wrapper's own counter."""
    key = (kernel, stream)
    STREAM_LAUNCHES[key] = STREAM_LAUNCHES.get(key, 0) + 1


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "memory_topk_batch_padded": (_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _P, _P, _P, _I, _P, _P, _P),
    "memory_top1_batch_padded": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                                 _P, _P),
    "ivf_route_batch_padded": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                               _I, _P, _P, _P),
    "ivf_scan_batch": (_P, _P, _P, _I, _P, _I, _I, _P, _I, _P, _P, _I, _P,
                       _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                       _I, _P, _P, _P),
    "flash_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _F, _I, _P),
    "decode_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _F, _I, _I, _I, _P, _P, _P),
    "moe_grouped_gemm": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "moe_combine": (_P, _P, _P, _P, _I, _I, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _digest() / "librepro_kernels.so"


#: nvcc's output of the last build (``-Xptxas -v``: registers, spills and
#: shared memory of every kernel), beside the library
PTXAS_LOG = "ptxas.log"


def ptxas_report(source: str) -> list[str]:
    """The ptxas lines of ``source`` (e.g. ``"flash_attention.cu"``) from
    the build's log, each kernel's "Compiling entry function" line joined
    with its "Used ... registers" and "spill" lines."""
    path = library_path().parent / PTXAS_LOG
    if not path.exists():
        return []
    lines, mine = [], False
    for line in path.read_text().splitlines():
        if line.startswith("== "):
            mine = line[3:] == source
        elif mine and ("Compiling entry" in line or "spill" in line or
                       "Used" in line):
            lines.append(line.split("ptxas info    :")[-1].strip())
    return lines


def build() -> Path:
    """Compile every source in parallel and link the library (skipped when
    the hashed library exists). Raises with nvcc's output on failure."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (src + ".o")
            cmd = [nvcc, *FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors, logs = [], []
        for src, _, p in procs:
            log = p.communicate()[0].decode(errors="replace")
            logs.append(f"== {src}\n{log}")
            if p.returncode:
                errors.append(f"{src}:\n{log}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        (out.parent / PTXAS_LOG).write_text("\n".join(logs))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, ARCH, "-shared", "-o", str(tmp_lib),
             *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" +
                               link.stdout.decode(errors="replace"))
        os.replace(tmp_lib, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _lib = loaded
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
