"""Build the CUDA kernels with nvcc and bind them through ctypes.

Each source in ``csrc/`` compiles, at first use, into its own shared
library with a plain C interface under ``kernels/build/`` (listed in
``.gitignore``).  A library's file name carries a hash of its source and
flags, so an edited source rebuilds and a stale library is never loaded.
Nothing is built or loaded when the module is imported.

``build_all()`` starts one nvcc per source at once and waits for all of
them (what ``chip_smoke.py`` does before it touches a kernel).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
SOURCES = ("quantize", "dequant_matmul")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         "-lineinfo")

_P, _I, _U, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_longlong,
                       ctypes.c_float)
SIGNATURES = {
    "quantize": {
        "qsdp_quantize_pack": (_P, _U, _U, _I, _P, _P, _P, _LL, _I, _I, _I, _F, _I, _P),
        "qsdp_unpack_dequantize": (_P, _P, _P, _P, _I, _LL, _I, _I, _P),
        "qsdp_unpack_dequantize_wire": (_P, _I, _P),
        "qsdp_quantize_buckets": (_P, _P, _P, _P, _P, _LL, _I, _I, _F, _I, _P),
        "qsdp_dequantize_buckets": (_P, _P, _P, _P, _I, _LL, _I, _P),
        "qsdp_random_bits": (_P, _I, _LL, _P, _P),
    },
    "dequant_matmul": {
        "qsdp_rowquant_matmul": (_P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P),
        "qsdp_rowquant_workspace": (_I, _I, _I, _I, _P, _P, _P),
    },
}

_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(ARCH_FLAGS + FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp, target, log) or
    None when the library is already built."""
    target = _lib_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    log = target.with_suffix(".log")
    cmd = [nvcc(), *ARCH_FLAGS, *FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, tmp, target, log


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, target, log = job
    rc = proc.wait()
    if rc != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {rc}):\n{log.read_text()}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing


def build_all() -> dict[str, str]:
    """Compile every source in parallel; returns {name: compiler log}."""
    jobs = {name: _start(name) for name in SOURCES}
    for name, job in jobs.items():
        _finish(name, job)
    out = {}
    for name in SOURCES:
        log = _lib_path(name).with_suffix(".log")
        out[name] = log.read_text() if log.exists() else ""
    return out


def load(name: str) -> ctypes.CDLL:
    """The bound library of source `name`, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    _finish(name, _start(name))
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, args in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(args)
        f.restype = ctypes.c_int
    _libs[name] = lib
    return lib
