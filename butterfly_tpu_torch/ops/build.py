"""Build and load the port's CUDA kernels (plain-C shared libraries).

Each kernel source under ops/csrc/ compiles with nvcc for sm_90a into its
own shared library, loaded with ctypes. Libraries land in
<repo>/build/butterfly_tpu_torch/ (git-ignored), named by a hash of the
source, the shared headers (csrc/*.cuh) and the flags, so an edited source
or header never loads a stale library.
The build runs at first use, one nvcc per missing library; `build_all`
starts one nvcc per source at once. Nothing here runs at import time.

    python -m butterfly_tpu_torch.ops.build      # build every kernel
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

_HERE = Path(__file__).resolve().parent
#: kernel name -> its CUDA source, relative to this directory
KERNEL_SOURCES: Dict[str, str] = {
    "paged_attention": "csrc/paged_attention.cu",
    "flash_attention": "csrc/flash_attention.cu",
    "ring_attention": "csrc/ring_attention.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
BUILD_DIR = _HERE.parent.parent / "build" / "butterfly_tpu_torch"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: kernel name -> (build seconds, nvcc's stderr: ptxas register/smem use)
build_log: Dict[str, tuple] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels build from source")
    return found


def library_path(name: str) -> Path:
    src = _HERE / KERNEL_SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for the kernel's library if it is missing. Returns
    (process, temp path, start time), or None when already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                             str(_HERE / KERNEL_SOURCES[name])],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, time.monotonic()


def _finish(name: str, started) -> float:
    """Wait for a started nvcc; install the library atomically. Returns
    the seconds it took; raises with nvcc's output if it failed."""
    proc, tmp, t0 = started
    stdout, stderr = proc.communicate()
    secs = time.monotonic() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):"
                           f"\n{stdout}\n{stderr}")
    os.replace(tmp, library_path(name))  # a reader never sees a partial .so
    build_log[name] = (secs, stderr)
    return secs


def build(name: str) -> Optional[float]:
    """Compile the kernel's library if it is missing. Returns the seconds
    nvcc took, or None when the library was already built; raises with
    nvcc's output if the build fails."""
    started = _start(name)
    return None if started is None else _finish(name, started)


def build_all() -> Dict[str, float]:
    """Build every missing library, one nvcc per source, all started
    together. Returns {name: seconds} for the ones built here; raises
    (after every nvcc has ended) if any build failed."""
    started = {}
    try:
        for name in KERNEL_SOURCES:
            st = _start(name)
            if st is not None:
                started[name] = st
    finally:
        times, errors = {}, []
        for name, st in started.items():
            try:
                times[name] = _finish(name, st)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(name: str) -> ctypes.CDLL:
    """The kernel's loaded library, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


if __name__ == "__main__":
    for n, s in build_all().items():
        print(f"built {n} in {s:.1f}s -> {library_path(n)}")
