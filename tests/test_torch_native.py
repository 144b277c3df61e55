"""PyTorch port: the native page allocator (native/__init__.py, the ctypes
binding of the repo's native/allocator.cc) and its build
(native/build.py), after tests/test_native.py.

The library is built with g++ into a temporary directory and the loader
pointed there. The C++ free list must be behaviourally identical to the
Python PageAllocator: the same page ids in the same order for any
operation sequence. make_page_allocator picks it when the library
loads and not under BUTTERFLY_NATIVE=0, and a scheduler on each
allocator gives the same greedy tokens.
"""
import shutil

import numpy as np
import pytest
import torch

from butterfly_tpu.cache.allocator import PageAllocator as JPageAllocator
from butterfly_tpu_torch import native
from butterfly_tpu_torch.cache.allocator import (PageAllocator,
                                                 make_page_allocator)
from butterfly_tpu_torch.core.config import RuntimeConfig, tiny
from butterfly_tpu_torch.engine.serving import ServingEngine
from butterfly_tpu_torch.models.common import Model
from butterfly_tpu_torch.native.build import build
from butterfly_tpu_torch.sched.scheduler import Scheduler

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ here: the native allocator cannot be built")
    path = build(tmp_path_factory.mktemp("native"), verbose=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_LIB_PATH", path)
        mp.setattr(native, "_lib", None)
        mp.delenv("BUTTERFLY_NATIVE", raising=False)
        assert native.native_available()
        yield path


def make_pair(num_pages=24, page=4, max_pages=8, slots=8):
    return (PageAllocator(num_pages, page, max_pages),
            native.NativePageAllocator(num_pages, page, max_pages, slots))


def test_build_lands_in_the_port_build_dir_by_default():
    assert native._LIB_PATH.parent.name == "butterfly_tpu_torch"
    assert native._LIB_PATH.parent.parent.name == "build"


def test_native_allocator_basic_parity(lib):
    py, cc = make_pair()
    assert cc.free_pages == py.free_pages == 24
    assert py.grow(0, 9) == cc.grow(0, 9)
    assert py.grow(0, 9) == cc.grow(0, 9) == []
    assert py.pages_of(0) == cc.pages_of(0)
    assert py.grow(1, 100) is None and cc.grow(1, 100) is None
    assert py.release(0) == cc.release(0)
    assert py.free_pages == cc.free_pages == 24
    assert cc.admit(2, [1, 2, 3], 5) == py.admit(2, [1, 2, 3], 5) == 0
    assert cc.register(2, [1, 2, 3]) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_allocator_property_parity(lib, seed):
    """A seeded workload of grows and releases on the port's native and
    Python allocators and the JAX package's Python one: every result
    and the observable state identical after every operation."""
    rng = np.random.RandomState(seed)
    py, cc = make_pair(num_pages=16, page=4, max_pages=6, slots=4)
    ref = JPageAllocator(16, 4, 6)
    lengths = {s: 0 for s in range(4)}
    for _ in range(1500):
        slot = int(rng.randint(4))
        if rng.rand() < 0.25:
            assert py.release(slot) == cc.release(slot) == ref.release(slot)
            lengths[slot] = 0
        else:
            new_len = lengths[slot] + int(rng.randint(1, 9))
            assert py.can_grow(slot, new_len) == cc.can_grow(slot, new_len)
            got = (py.grow(slot, new_len), cc.grow(slot, new_len),
                   ref.grow(slot, new_len))
            assert got[0] == got[1] == got[2]
            if got[0] is not None:
                lengths[slot] = new_len
        assert py.free_pages == cc.free_pages == ref.free_pages
        assert py.pages_of(slot) == cc.pages_of(slot)


def test_native_allocator_exhaustion_and_slot_range(lib):
    _, cc = make_pair(num_pages=4, page=4, max_pages=8, slots=2)
    assert cc.grow(0, 12) == [0, 1, 2]
    assert cc.grow(1, 8) is None
    assert cc.free_pages == 1
    assert cc.grow(1, 4) == [3]
    with pytest.raises(IndexError):
        cc.grow(2, 4)


def test_factory_picks_native_unless_disabled(lib, monkeypatch):
    assert isinstance(make_page_allocator(8, 4, 4, 2),
                      native.NativePageAllocator)
    monkeypatch.setenv("BUTTERFLY_NATIVE", "0")
    assert type(make_page_allocator(8, 4, 4, 2)) is PageAllocator


def test_scheduler_tokens_equal_on_both_allocators(lib, monkeypatch):
    """The scheduler's admission / growth / preemption loop (a pool of 6
    pages for two slots) gives the same tokens on the native allocator
    as on the Python one."""
    model = Model(tiny("llama", dtype="float32", param_dtype="float32"),
                  device="cpu")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(42)
    params = model.init(gen)
    rt = RuntimeConfig(max_batch_size=2, max_seq_len=32, page_size=4,
                       num_pages=6)

    def run(flag):
        monkeypatch.setenv("BUTTERFLY_NATIVE", flag)
        sched = Scheduler(ServingEngine(model, params, rt))
        assert type(sched.alloc).__name__ == (
            "NativePageAllocator" if flag == "1" else "PageAllocator")
        reqs = [sched.submit([5, 7, 11], max_new_tokens=10),
                sched.submit([3, 1], max_new_tokens=10)]
        sched.run_until_done(max_ticks=300)
        return [r.output for r in reqs], sched.metrics()

    (native_out, nm), (py_out, pm) = run("1"), run("0")
    assert native_out == py_out
    assert all(len(o) == 10 for o in native_out)
    assert nm["preemptions_total"] == pm["preemptions_total"] > 0
