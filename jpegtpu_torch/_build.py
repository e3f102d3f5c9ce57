"""Build and load the hand-written CUDA kernels (csrc/*.cu), and launch them.

Each source compiles with nvcc, on first use, into its own shared
library with a plain C interface under `build/jpegtpu_torch/` (rebuilt
when a source or header is newer), and loads with ctypes. Sources compile
in parallel (`build_all`). Every C entry point launches on the stream it
is given and returns `cudaGetLastError()`; `launch` raises when that is
not 0 and counts the launch.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "jpegtpu_torch")

KERNEL_SOURCES = ("transform", "pack", "concat")

# Launches per kernel since the last reset, counted where each wrapper
# launches its kernel (and nowhere else).
LAUNCHES = {"transform": 0, "encode_blocks": 0, "merge_rows": 0,
            "stream_concat": 0}

_lock = threading.Lock()
_libs: dict = {}


def _fresh(so: str, srcs) -> bool:
    return os.path.exists(so) and os.path.getmtime(so) >= max(
        os.path.getmtime(s) for s in srcs
    )


def compile_if_stale(so: str, srcs, command) -> None:
    """Run command(tmp_path) to build `so` unless it is newer than every
    source; the output is renamed into place, so concurrent builders in
    other processes never load a half-written library."""
    if _fresh(so, srcs):
        return
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.run(command(tmp), check=True, capture_output=True, text=True)
    os.replace(tmp, so)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _paths(name: str):
    src = os.path.join(CSRC, f"{name}.cu")
    deps = [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    return src, deps, os.path.join(BUILD_DIR, f"libjt_{name}.so")


def _nvcc_command(src: str, out: str) -> list:
    return [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
        "-o", out, src,
    ]


def build_all() -> dict:
    """Compile every stale kernel source, one nvcc per source, all at once.
    Returns {name: ptxas report} for the sources it compiled; raises with
    the compiler's output if any build fails."""
    procs = {}
    for name in KERNEL_SOURCES:
        src, deps, so = _paths(name)
        if _fresh(so, deps):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        procs[name] = (tmp, so, subprocess.Popen(
            _nvcc_command(src, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
    reports, failed = {}, []
    for name, (tmp, so, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def _lib(name: str):
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src, deps, so = _paths(name)
            compile_if_stale(so, deps, lambda out: _nvcc_command(src, out))
            lib = _libs[name] = ctypes.CDLL(so)
        return lib


def launch(source: str, kernel: str, argtypes, *args, device) -> None:
    """Call C entry `jt_<kernel>` of csrc/<source>.cu on the current CUDA
    stream of `device` (appended as the last argument), raise if it
    reports a CUDA error, and count the launch."""
    fn = getattr(_lib(source), f"jt_{kernel}")
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[kernel] += 1


def require_cuda(t: torch.Tensor, name: str, dtype) -> None:
    """The kernels take contiguous tensors of one dtype on a CUDA device."""
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} CUDA tensor, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
