"""Build and load the CUDA kernels (``kernels/csrc/*.cu``) at first use.

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a`` with a plain ``extern "C"`` interface; the objects are linked
into one shared library that ``ctypes`` loads. The output directory is
``build/kernels-<hash of the sources>`` at the root of the checkout (listed
in ``.gitignore``), so an edited source gets a fresh build and an unchanged
one is reused. Nothing here runs at import time: a module that imports this
one needs neither ``nvcc`` nor a card.
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
SOURCES = ("hop_fused.cu", "or_scatter.cu", "prune_scan.cu", "pq_scan.cu",
           "approx_probe.cu", "l2_rerank.cu")
# headers the sources include, hashed with them
HEADERS = ("smem_optin.cuh",)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of each entry point: every pointer and the stream as c_void_p
SIGNATURES = {
    "hop_fused_launch": [_P] * 12 + [_I] * 7 + [_P],
    "hop_fused_gather_launch": [_P] * 13 + [ctypes.c_longlong] + [_I] * 8
    + [_P],
    "or_scatter_launch": [_P] * 3 + [_I] * 3 + [_P],
    "or_scatter_inplace_launch": [_P] * 2 + [_I] * 4 + [_P],
    "prune_scan_launch": [_P] * 3 + [_I, _I, ctypes.c_float, _I, _P],
    "pq_scan_u8_launch": [_P] * 3 + [ctypes.c_longlong, _I, _I, _P],
    "pq_scan_i32_launch": [_P] * 3 + [ctypes.c_longlong, _I, _I, _P],
    "pq_scan_gather_u8_launch": [_P] * 4 + [ctypes.c_longlong] * 2
    + [_I, _I, _P],
    "pq_scan_gather_i32_launch": [_P] * 4 + [ctypes.c_longlong] * 2
    + [_I, _I, _P],
    "approx_probe_u8_launch": [_P] * 5 + [ctypes.c_longlong, _I, _P],
    "approx_probe_i32_launch": [_P] * 5 + [ctypes.c_longlong, _I, _P],
    "l2_rerank_launch": [_P] * 3 + [ctypes.c_longlong, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                       "use on a machine with the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link ``libkernels.so``; returns
    its path. Reuses an existing build of the same sources."""
    out_dir = BUILD_ROOT / f"kernels-{source_hash()}"
    lib_path = out_dir / "libkernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, _, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / "libkernels.so"
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_lib, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
    return _lib
