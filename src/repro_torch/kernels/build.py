"""Build and bind the hand-written CUDA kernels under `kernels/csrc/`.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
into `build/kernels/lib<name>-<hash>.so` at the repository root (the hash is
over the source and the headers it may include, `csrc/*.cuh`, so an edited
kernel is rebuilt and a stale library is never loaded), then loaded with
ctypes. Nothing is built or loaded at import: the
first launch builds, or `build_all()` builds every source at once with one
`nvcc` per source running in parallel.

Every C entry point launches on the caller's stream and returns the
`cudaGetLastError()` code of its launch; `Kernel.__call__` raises when it is
not 0 and counts the launch otherwise.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gemm", "paged_attn", "flash_attn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit on PATH or in "
                       "CUDA_HOME)")


def lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    tag = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (Popen, temporary path, final
    path), or None if the library for this source already exists."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names=SOURCES) -> dict[str, str]:
    """Build every kernel library, one nvcc per source, all in parallel.
    Returns name -> the ptxas report (registers, shared memory, spills)."""
    jobs = {n: _start_build(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish_build(n, job)
    logs = {}
    for n in names:
        log = BUILD_DIR / f"{n}.log"
        logs[n] = log.read_text() if log.exists() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            job = _start_build(name)
            if job is not None:
                _finish_build(name, job)
            _libs[name] = ctypes.CDLL(str(lib_path(name)))
        return _libs[name]


class Kernel:
    """One C launcher of a built library, with its launch count.

    `argtypes` are the ctypes types of the C function's arguments; every
    launcher takes the CUDA stream last and returns a cudaError_t."""

    def __init__(self, lib: str, symbol: str, argtypes):
        self.lib, self.symbol, self.argtypes = lib, symbol, list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args, stream: int | None = None) -> None:
        """Launch on `stream` (a cudaStream_t handle), by default the
        current stream."""
        if self._fn is None:
            fn = getattr(load(self.lib), self.symbol)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        if stream is None:
            stream = torch.cuda.current_stream().cuda_stream
        err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA launch failed with "
                               f"cudaError {err}")
        self.launches += 1
