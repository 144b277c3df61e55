"""Build and load the port's CUDA kernels (plain-C shared libraries).

Each kernel source under ops/csrc/ compiles with nvcc for sm_90a into its
own shared library, loaded with ctypes. Libraries land in
<repo>/build/butterfly_tpu_torch/ (git-ignored), named by a hash of the
source and the flags, so an edited source never loads a stale library.
The build runs at first use, one nvcc per missing library. Nothing here
runs at import time.

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
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Optional[float]:
    """Compile the kernel's library if it is missing. Returns the seconds
    nvcc took, or None when the library was already built; raises with
    nvcc's output if the build fails."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.monotonic()
    p = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                        str(_HERE / KERNEL_SOURCES[name])],
                       capture_output=True, text=True)
    secs = time.monotonic() - t0
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {p.returncode}):\n"
                           f"{p.stdout}\n{p.stderr}")
    os.replace(tmp, out)  # atomic: a reader never sees a partial .so
    build_log[name] = (secs, p.stderr)
    return secs


def build_all() -> Dict[str, float]:
    """Build every missing library, one source after another. Returns
    {name: seconds} for the ones built here."""
    times = {}
    for name in KERNEL_SOURCES:
        secs = build(name)
        if secs is not None:
            times[name] = secs
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
