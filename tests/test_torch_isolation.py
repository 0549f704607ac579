"""The port stands alone: no JAX, flax, optax, msgpack or amss_tpu import, no
silent move to the CPU, and CUDA tensors go to a kernel or raise."""

import ast
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "msgpack", "amss_tpu"}


def _port_files():
    return sorted((REPO / "amss_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_import_leaves_jax_and_the_jax_package_out():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import amss_tpu_torch, amss_tpu_torch.infer.streaming, amss_tpu_torch.ckpt.checkpoint\n"
        "import amss_tpu_torch.weights, amss_tpu_torch.ops.metrics, amss_tpu_torch.data.synthetic\n"
        "import amss_tpu_torch.train.engine, amss_tpu_torch.configs.recipes\n"
        "import amss_tpu_torch.models.adapt, amss_tpu_torch.ops.pooling, amss_tpu_torch.infer.long\n"
        "import amss_tpu_torch.tools.stage_times, amss_tpu_torch.infer.realtime\n"
        "import amss_tpu_torch.models.l41, amss_tpu_torch.models.chimera\n"
        "import amss_tpu_torch.infer.count, amss_tpu_torch.models.enhance\n"
        "import amss_tpu_torch.models.dprnn, amss_tpu_torch.models.dptransformer\n"
        "import amss_tpu_torch.models.sepformer\n"
        "import amss_tpu_torch.infer.evaluate, amss_tpu_torch.ops.bss_eval\n"
        "import amss_tpu_torch.ops.stoi, amss_tpu_torch.data.resample, amss_tpu_torch.data.store\n"
        "import amss_tpu_torch.cli, amss_tpu_torch.__main__, amss_tpu_torch.infer.export\n"
        "import amss_tpu_torch.infer.server, amss_tpu_torch.infer.quantize, amss_tpu_torch.ckpt.tree\n"
        "import amss_tpu_torch.utils.profiling, amss_tpu_torch.utils.debug\n"
        "import amss_tpu_torch.data.native, amss_tpu_torch.data.device_corpus\n"
        "import amss_tpu_torch.parallel.mesh, amss_tpu_torch.parallel.timeshard\n"
        "import amss_tpu_torch.ops.blstm_bf16\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(BANNED)!r})\n"
        "print(','.join(bad))\n"
    )
    # -I: no PYTHONPATH or user site, so nothing but the port can import JAX
    out = subprocess.run([sys.executable, "-I", "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"port imported {out.stdout.strip()}"


def test_artifact_loader_imports_no_model_module():
    """Loading and serving an artifact needs no model code: the import
    closure of the loader and the server holds no ``amss_tpu_torch.models``
    module (nor ``weights``, which imports them)."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import amss_tpu_torch.infer.export, amss_tpu_torch.infer.server\n"
        "bad = sorted(m for m in sys.modules if m.startswith(('amss_tpu_torch.models',\n"
        "             'amss_tpu_torch.weights', 'amss_tpu_torch.train')))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-I", "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"the loader imported {out.stdout.strip()}"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_banned_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in BANNED, f"{path.name}:{node.lineno} imports {n}"


def test_stage_times_reaches_the_models_through_public_names():
    """The span reader imports no ``_``-prefixed name and no model module, and
    reads no ``_``-prefixed attribute, so a model's internals may change
    under it."""
    path = REPO / "amss_tpu_torch" / "tools" / "stage_times.py"
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names = [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.Attribute):
            assert not node.attr.startswith("_"), f"{path.name}:{node.lineno} reads {node.attr}"
            continue
        else:
            continue
        for n in names:
            parts = n.split(".")
            assert not any(p.startswith("_") for p in parts), f"{path.name}:{node.lineno} {n}"
            assert parts[:2] != ["amss_tpu_torch", "models"], f"{path.name}:{node.lineno} {n}"


def test_streaming_separator_raises_without_cuda(monkeypatch):
    from amss_tpu_torch.infer.streaming import StreamingSeparator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingSeparator(torch.nn.Identity())


def test_weights_loader_raises_without_cuda(monkeypatch):
    from amss_tpu_torch.weights import load_model_from_run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model_from_run(str(REPO / "checkpoints" / "c1_dpcl"))


def test_count_and_enhance_entry_points_raise_without_cuda(monkeypatch):
    from amss_tpu_torch.configs.recipes import enh_dpcl
    from amss_tpu_torch.infer.count import separate_auto_k
    from amss_tpu_torch.models.dpcl import DPCLModel
    from amss_tpu_torch.train.engine import make_model
    from amss_tpu_torch.utils.config import ModelConfig, SeparatorConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = DPCLModel(ModelConfig(sep=SeparatorConfig(hidden=4, layers=1, embed_dim=5)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        separate_auto_k(model, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_model(enh_dpcl().model, str(REPO / "checkpoints" / "c1_dpcl"))


def _fake_cuda(*shape):
    """Stands in for a CUDA tensor where torch has no CUDA: the wrappers read
    only its device, dtype and shape before they reach the kernel."""
    return SimpleNamespace(device=torch.device("cuda", 0), dtype=torch.float32,
                           shape=torch.Size(shape), dim=lambda: len(shape))


def test_kernel_wrappers_never_take_the_plain_path_for_cuda(monkeypatch):
    from amss_tpu_torch.ops.kernels.framed_matmul import framed_matmul
    from amss_tpu_torch.ops.kernels.ola import decode_ola

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        framed_matmul(_fake_cuda(2, 4096), _fake_cuda(256, 258), 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_ola(_fake_cuda(2, 61, 258), _fake_cuda(258, 256), 64, length=4096)
    assert framed_matmul.launches == 0 and decode_ola.launches == 0


def test_kernel_wrappers_raise_on_other_devices():
    from amss_tpu_torch.ops.kernels.framed_matmul import framed_matmul
    from amss_tpu_torch.ops.kernels.ola import decode_ola

    x = torch.empty((2, 4096), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        framed_matmul(x, torch.empty((256, 258), device="meta"), 64)
    with pytest.raises(ValueError, match="cpu or cuda"):
        decode_ola(torch.empty((2, 61, 258), device="meta"),
                   torch.empty((258, 256), device="meta"), 64)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from amss_tpu_torch.ops.kernels import build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
