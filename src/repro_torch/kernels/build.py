"""Build and load the port's CUDA kernels (one shared library).

Every `csrc/*.cu` is compiled by its own `nvcc` process, all started
together, for `sm_90a`, then linked into one shared library with a plain
C interface and loaded with ctypes. The library lands in `build/` at the
repository root under a name that hashes the sources and flags, so an
edited kernel is rebuilt and an unchanged one is loaded as built.
Nothing here runs at import time: the first wrapper call builds.
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
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

P, I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> argtypes. Each returns cudaGetLastError().
SIGNATURES = {
    "ternary_matmul": [P, P, P, P, I, I, I, I, P],
    "dense_matmul": [P, P, P, I, I, I, I, I, P],
    "dual_plane_matmul": [P, P, P, P, P, P, P, I, I, I, I, P],
    "quantize_pack_kv": [P, P, P, I, I, P],
    "quantize_pack_kv_masked": [P, P, P, P, I, I, P],
    "quantize_pack_kv_integrity": [P, P, P, P, I, I, P],
    "paged_kv_write": [P] * 13 + [I] * 15 + [P],
    "packed_kv_attention": [P, P, P, P, P, P, P, P, P,
                            I, I, I, I, I, I, I, P],
    "paged_kv_attention": [P, P, P, P, P, P, P, P, P, P, P, P,
                           I, I, I, I, I, I, I, I, P],
    "paged_kv_attention_window": [P, P, P, P, P, P, P, P, P, P, P, P,
                                  I, I, I, I, I, I, I, I, I, I, P],
    "imc_quantize": [P, P, P, I, I, I, P],
    "imc_dot": [P, P, P, P, P, I, I, I, I, I, P],
    "imc_dual_dot": [P, P, P, P, P, P, P, I, I, I, I, P],
    "imc_decode_plan": [I, I, P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"repro_torch_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile (if needed) and return the shared library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        # wait for every compile before judging any, so no nvcc outlives us
        logs = [(src, proc.communicate()[0], proc.returncode)
                for src, _, proc in procs]
        for src, log, rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
            if verbose:
                print(f"[nvcc {src.name}]\n{log}", flush=True)
        tmp_lib = Path(tmp) / out.name
        link = [nvcc, *NVCC_FLAGS, "-shared",
                *[str(obj) for _, obj, _ in procs], "-o", str(tmp_lib)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp_lib, out)     # atomic: concurrent builds agree
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
