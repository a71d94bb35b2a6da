"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface and loaded with `ctypes`. The build runs
at first use, from the sources in the checkout, into `build/clipcap_tpu_torch/`
at the root of the checkout (git-ignored); the library name carries a hash
of its source, so an edited kernel is rebuilt. Nothing here runs at import.
With a tracer active (utils/profiling.py), each `nvcc` is recorded as an
interval `kernels.build` with the kernel's name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

from ...utils import profiling as P

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "clipcap_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit's "
                       "nvcc (on PATH or under $CUDA_HOME/bin)")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel source not yet built, one `nvcc` per
    source, all started together. Returns each compiler's output by name
    (with ptxas's registers, shared memory and spills per kernel) for the
    sources it built; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tr = P.active()
    procs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, P.now_ns(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = {}
    failed = []
    for name, out, tmp, t0, proc in procs:
        logs[name], _ = proc.communicate()
        if tr is not None:
            tr.interval("kernels.build", t0, P.now_ns(), kernel=name)
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed for " + ", ".join(failed) + "\n" + "\n".join(
            f"== nvcc {name}.cu\n{log}" for name, log in logs.items()))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                build([name])
            lib = ctypes.CDLL(str(target))
            _libs[name] = lib
        return lib


def check_cuda_tensor(name: str, t: torch.Tensor, dtypes, shape=None) -> None:
    """Raise unless t is a contiguous CUDA tensor of an accepted dtype/shape."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")


def raise_on_error(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
