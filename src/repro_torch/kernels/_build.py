"""Build the port's CUDA sources at first use and bind them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` for ``sm_90a`` into ``build/repro_torch_kernels/`` at the
root of the checkout.  The library's file name carries a hash of the source
and the flags, so an edited source is rebuilt and a stale library is never
loaded.  ``build`` starts one ``nvcc`` per source, all at once, and waits
for every one of them before it reports a failure.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("flash_attention", "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_functions: dict = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=SOURCES, verbose=False) -> dict:
    """Compile every source in ``names`` that has no library yet.

    Returns the compiler's output per source built (with ``verbose``, what
    ``-Xptxas -v`` says of registers, shared memory and spills)."""
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (out, tmp, proc) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n} ---\n{logs[n]}" for n in failed))
    return logs


def function(name: str, symbol: str, argtypes):
    """The C function ``symbol`` of ``csrc/<name>.cu``, built if need be.
    Every C entry returns a ``cudaError_t`` as an int."""
    key = (name, symbol)
    with _lock:
        fn = _functions.get(key)
        if fn is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            err = lib.repro_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            fn.error_string = err
            _functions[key] = fn
    return fn


def check(fn, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(
            f"{what}: CUDA error {rc} ({fn.error_string(rc).decode()})")
