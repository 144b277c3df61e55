"""Build the port's native runtime lib:

    python -m butterfly_tpu_torch.native.build

Compiles the repo's native/allocator.cc with g++ (the flags of
native/Makefile) into build/butterfly_tpu_torch/libbutterfly_native.so,
the path native/__init__.py loads. The library is written under a
temporary name and renamed into place, so a concurrent loader never
opens a partial file.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

from butterfly_tpu_torch.native import _LIB_PATH

SOURCE = Path(__file__).resolve().parents[2] / "native" / "allocator.cc"
CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared"]


def build(out_dir: Optional[Path] = None, verbose: bool = True) -> Path:
    """Compile the allocator into `out_dir` (default: the loader's
    directory). Returns the library's path; raises on a failed build."""
    out = (Path(out_dir) if out_dir is not None else _LIB_PATH.parent) \
        / _LIB_PATH.name
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXXFLAGS, "-o", str(tmp), str(SOURCE)]
    if verbose:
        print(" ".join(cmd))
    try:
        subprocess.run(cmd, check=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


if __name__ == "__main__":
    path = build()
    print(f"built {path}")
    sys.exit(0)
