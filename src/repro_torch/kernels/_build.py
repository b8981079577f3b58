"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into a shared
library of its own with a plain C interface; all sources build at once,
one `nvcc` process each.  Libraries go to `build/repro_torch/` at the
root of the checkout (git-ignored), under a name that carries a hash of
the source, so an edited kernel is rebuilt and an unchanged one reused.
`ptxas -v` output (registers, shared memory, spills) lands beside each
library as `<lib>.log`.

Every exported launcher returns `cudaGetLastError()` after its launches;
`launch` turns a nonzero code into an exception.  Nothing here runs at
import time: the CPU tests import every module and have no `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Launches per kernel wrapper: each wrapper adds one where it launches its
# kernel and nowhere else (the plain CPU path does not count).
LAUNCHES = {"keyswitch_mac": 0, "fft_forward": 0, "fft_inverse": 0,
            "external_product_mac": 0}

_LIBS: dict = {}
_FUNCS: dict = {}
_LOCK = threading.Lock()


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:12]}.so"


def build_all() -> dict:
    """Compile every `csrc/*.cu` not built yet (in parallel) and load all.
    Returns {source stem: ctypes.CDLL}.  Raises on any failed build."""
    with _LOCK:
        if _LIBS:
            return dict(_LIBS)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        sources = sorted(CSRC.glob("*.cu"))
        jobs = []
        for src in sources:
            out = _lib_path(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = open(out.with_suffix(".log"), "w")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            jobs.append((src, out, tmp, log,
                         subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for src, out, tmp, log, proc in jobs:
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(f"{src.name}: nvcc exited {rc}\n"
                              + out.with_suffix(".log").read_text()[-4000:])
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for src in sources:
            _LIBS[src.stem] = ctypes.CDLL(str(_lib_path(src)))
        return dict(_LIBS)


def build_logs() -> dict:
    """{source stem: nvcc/ptxas output of its last build}."""
    return {src.stem: _lib_path(src).with_suffix(".log").read_text()
            for src in sorted(CSRC.glob("*.cu"))
            if _lib_path(src).with_suffix(".log").exists()}


def function(lib: str, name: str, n_ptr: int, n_int: int):
    """The exported launcher `name` of `lib`: `n_ptr` pointer arguments,
    then `n_int` int arguments, then the stream; returns an int error."""
    fn = _FUNCS.get((lib, name))
    if fn is None:
        dll = build_all()[lib]
        fn = getattr(dll, name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = dll.error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        fn.error_string = err
        _FUNCS[(lib, name)] = fn
    return fn


def launch(kernel: str, fn, *args, device: torch.device) -> None:
    """Call launcher `fn` on the current stream of `device`, raise on a
    nonzero CUDA error, and count the launch under `kernel`."""
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"{kernel}: tensors on {device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} "
                           f"({fn.error_string(rc).decode()})")
    LAUNCHES[kernel] += 1


def require(kernel: str, cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"{kernel}: {what}")
