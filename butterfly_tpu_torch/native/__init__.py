"""ctypes bindings for the native (C++) runtime components.

The compute path is PyTorch and the CUDA kernels; the host runtime
around it — here the paged-KV page allocator on the scheduler's hot
path — has a native implementation (the repo's native/allocator.cc)
with this loader and a pure-Python fallback (cache/allocator.py),
selected automatically:

* lib present  -> NativePageAllocator (identical semantics, parity-
  tested in tests/test_torch_native.py)
* lib absent   -> Python PageAllocator (no build step required)
* BUTTERFLY_NATIVE=0 forces the Python path.

Build the lib with `python -m butterfly_tpu_torch.native.build`; it
lands in build/butterfly_tpu_torch/ (git-ignored) beside the kernels'
libraries, never next to the JAX package's. A copy of
butterfly_tpu/native/__init__.py but for that path.
"""
from __future__ import annotations

import ctypes
import os
from typing import List, Optional

from butterfly_tpu_torch.ops.build import BUILD_DIR

_LIB_PATH = BUILD_DIR / "libbutterfly_native.so"
_lib = None


def load_native():
    """The loaded CDLL, or None (missing lib / disabled via env).

    The env gate is re-read on every call so BUTTERFLY_NATIVE=0 takes
    effect immediately even after the lib was loaded once; only the
    CDLL handle itself is cached.
    """
    global _lib
    if os.environ.get("BUTTERFLY_NATIVE", "1") == "0":
        return None
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    i32, p = ctypes.c_int32, ctypes.c_void_p
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.bfa_create.restype = p
    lib.bfa_create.argtypes = [i32, i32, i32, i32]
    lib.bfa_destroy.argtypes = [p]
    lib.bfa_free_pages.restype = i32
    lib.bfa_free_pages.argtypes = [p]
    lib.bfa_pages_of.restype = i32
    lib.bfa_pages_of.argtypes = [p, i32, i32p]
    lib.bfa_can_grow.restype = i32
    lib.bfa_can_grow.argtypes = [p, i32, i32]
    lib.bfa_grow.restype = i32
    lib.bfa_grow.argtypes = [p, i32, i32, i32p]
    lib.bfa_release.restype = i32
    lib.bfa_release.argtypes = [p, i32]
    _lib = lib
    return _lib


def native_available() -> bool:
    return load_native() is not None


class NativePageAllocator:
    """Drop-in for cache.allocator.PageAllocator over the C++ free list.

    Same constructor signature plus `num_slots` (the C side bounds its
    slot table; the Python dict is unbounded). cache.allocator's
    make_page_allocator picks between the two.
    """

    def __init__(self, num_pages: int, page_size: int,
                 max_pages_per_seq: int, num_slots: int = 4096):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native allocator library not available")
        self._lib = lib
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self._buf = (ctypes.c_int32 * max(1, max_pages_per_seq))()
        self._num_slots = num_slots
        self._h = lib.bfa_create(num_pages, page_size, max_pages_per_seq,
                                 num_slots)
        if not self._h:
            raise ValueError("invalid allocator parameters")

    def _check_slot(self, slot: int) -> None:
        # The C side range-checks defensively (refuses silently); the
        # Python fallback is an unbounded dict — raise here so an
        # out-of-range slot is a loud caller bug on BOTH backends
        # instead of backend-dependent starvation.
        if not 0 <= slot < self._num_slots:
            raise IndexError(
                f"slot {slot} out of range [0, {self._num_slots})")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.bfa_destroy(h)
            self._h = None

    @property
    def free_pages(self) -> int:
        return int(self._lib.bfa_free_pages(self._h))

    def pages_of(self, slot: int) -> List[int]:
        self._check_slot(slot)
        n = self._lib.bfa_pages_of(self._h, slot, self._buf)
        return list(self._buf[:n])

    def pages_needed(self, slot: int, new_length: int) -> int:
        have = len(self.pages_of(slot))
        want = -(-new_length // self.page_size)
        return max(0, want - have)

    def can_grow(self, slot: int, new_length: int) -> bool:
        self._check_slot(slot)
        return bool(self._lib.bfa_can_grow(self._h, slot, new_length))

    def grow(self, slot: int, new_length: int) -> Optional[List[int]]:
        self._check_slot(slot)
        n = self._lib.bfa_grow(self._h, slot, new_length, self._buf)
        if n < 0:
            return None
        return list(self._buf[:n])

    def release(self, slot: int) -> List[int]:
        self._check_slot(slot)
        pages = self.pages_of(slot)
        self._lib.bfa_release(self._h, slot)
        return pages

    # -- prefix-caching interface (same no-op contract as the Python
    # PageAllocator; the refcounted variant lives in cache/prefix.py) ----

    def admit(self, slot: int, tokens, need_len: int) -> Optional[int]:
        return None if self.grow(slot, need_len) is None else 0

    def register(self, slot: int, tokens) -> int:
        return 0
