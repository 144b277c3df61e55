"""PyTorch port: configuration parity with the JAX package, and import
hygiene (the port never imports jax or butterfly_tpu)."""
import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from butterfly_tpu.core import config as jcfg
from butterfly_tpu_torch.core import config as tcfg

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", ["ModelConfig", "MeshConfig",
                                  "RuntimeConfig"])
def test_config_fields_match(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(j)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(t)]
    assert jf == tf
    assert dataclasses.asdict(j()) == dataclasses.asdict(t())


@pytest.mark.parametrize("preset", sorted(jcfg.PRESETS) + ["tiny"])
def test_presets_match(preset):
    if preset == "tiny":
        for arch in ("llama", "gpt2", "mixtral"):
            assert dataclasses.asdict(jcfg.tiny(arch)) == \
                dataclasses.asdict(tcfg.tiny(arch))
        return
    assert dataclasses.asdict(jcfg.PRESETS[preset]()) == \
        dataclasses.asdict(tcfg.PRESETS[preset]())


def _port_files():
    files = sorted((REPO / "butterfly_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_never_imports_jax_or_the_jax_package():
    bad = []
    files = _port_files()
    assert len(files) > 10
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {"butterfly_tpu_torch/core/mesh.py",
            "butterfly_tpu_torch/parallel/sequence.py",
            "butterfly_tpu_torch/ops/ring_attention.py",
            "butterfly_tpu_torch/cache/prefix.py",
            "butterfly_tpu_torch/cache/hosttier.py",
            "butterfly_tpu_torch/fleet/kvtransfer.py",
            "butterfly_tpu_torch/workload/models.py",
            "butterfly_tpu_torch/workload/arrivals.py",
            "butterfly_tpu_torch/workload/sweep.py",
            "butterfly_tpu_torch/obs/benchmark.py",
            "butterfly_tpu_torch/quant/int8.py",
            "butterfly_tpu_torch/models/draft.py",
            "butterfly_tpu_torch/router/pool.py",
            "butterfly_tpu_torch/router/policy.py",
            "butterfly_tpu_torch/router/proxy.py",
            "butterfly_tpu_torch/fleet/controlplane.py",
            "butterfly_tpu_torch/fleet/harness.py",
            "butterfly_tpu_torch/fleet/autoscale.py",
            "butterfly_tpu_torch/fleet/chaos.py",
            "butterfly_tpu_torch/workload/replay.py",
            "butterfly_tpu_torch/workload/loadgen.py",
            "butterfly_tpu_torch/native/__init__.py",
            "butterfly_tpu_torch/native/build.py"} <= names
    for f in files:
        tree = ast.parse(f.read_text(), filename=str(f))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                if root in ("jax", "jaxlib", "butterfly_tpu"):
                    bad.append(f"{f.relative_to(REPO)}:{node.lineno} {n}")
    assert not bad, f"forbidden imports: {bad}"


def test_cuda_requested_without_card_raises():
    from butterfly_tpu_torch.core.device import resolve_device
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
