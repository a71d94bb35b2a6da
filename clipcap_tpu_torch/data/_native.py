"""Build the port's own copies of the native host libraries.

Each `native/<name>.cpp` at the root of the checkout is compiled by `g++`
into a shared library with a plain C interface, at first use, into
`build/clipcap_tpu_torch/native/` (git-ignored). The library name carries a
hash of its source and flags, so an edited source is rebuilt. The JAX
package's libraries under `native/` are never written or loaded here.

Several processes may build at once (the test runner's workers): each
build holds an exclusive file lock, compiles into a temporary file and
renames it into place, so no process loads a half-written library.
Nothing here runs at import.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_SRC = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "clipcap_tpu_torch" / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]


def library_path(name: str, link: Sequence[str] = ()) -> Path:
    src = NATIVE_SRC / f"{name}.cpp"
    key = src.read_bytes() + " ".join([*CXX_FLAGS, *link]).encode()
    return BUILD_DIR / f"lib{name}_{hashlib.sha1(key).hexdigest()[:12]}.so"


def build(name: str, link: Sequence[str] = ()) -> Path:
    """The built library of `native/<name>.cpp`, compiled first if needed.
    Raises OSError when g++ or the source is missing and RuntimeError with
    the compiler's output when the build fails."""
    out = library_path(name, link)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise OSError("g++ not found: the native libraries are built with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                                   str(NATIVE_SRC / f"{name}.cpp"), *link],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build native/{name}.cpp:\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out
