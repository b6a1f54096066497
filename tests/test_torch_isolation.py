"""PyTorch port, ground rules: it imports nothing of JAX or the JAX package,
runs on the card unless asked for the CPU, and has no fallback that hides
the device or the kernel."""

import ast
from pathlib import Path

import jax  # noqa: F401  (both frameworks in one process, as the other tests)
import pytest
import torch

from kuberay_tpu_torch.models import llama
from kuberay_tpu_torch.ops import attention as fa
from kuberay_tpu_torch.ops import decode_attention as da
from kuberay_tpu_torch.ops import rmsnorm as rn
from kuberay_tpu_torch.serve import engine, server

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "kuberay_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "optax", "kuberay_tpu")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_port_imports_nothing_of_jax_or_the_jax_package():
    assert len(PORT_FILES) > 10
    bad = [(p.relative_to(ROOT), m)
           for p in PORT_FILES
           for m in _imported_modules(ast.parse(p.read_text()))
           if m.split(".")[0] in FORBIDDEN]
    assert not bad


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.CONFIGS["llama_tiny"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_params(cfg)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.ServeEngine(cfg, params, max_slots=1, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.main(["--model", "llama_tiny", "--port", "0"])
    # Asked for the CPU, they run.
    eng = engine.ServeEngine(cfg, params, max_slots=1, max_len=16,
                             device="cpu")
    assert eng.device.type == "cpu"


def test_engine_rejects_params_on_another_device():
    cfg = llama.CONFIGS["llama_tiny"]
    params = llama.init_params(cfg, None, "meta")
    with pytest.raises(ValueError, match="params are on"):
        engine.ServeEngine(cfg, params, max_slots=1, max_len=16, device="cpu")


def test_kernel_modules_have_no_fallback():
    """No try/except in the kernel wrappers or the build: a CUDA tensor
    launches the kernel or raises."""
    for name in ("rmsnorm.py", "decode_attention.py", "attention.py",
                 "_build.py"):
        tree = ast.parse(
            (ROOT / "kuberay_tpu_torch" / "ops" / name).read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], name


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError):
        rn.rmsnorm(x, torch.empty(8, device="meta"))
    q = torch.empty(2, 4, 16, device="meta")
    c = torch.empty(2, 8, 2, 16, device="meta")
    with pytest.raises(ValueError):
        da.decode_attention(q, c, c, torch.empty(2, device="meta"))
    q = torch.empty(1, 64, 2, 64, device="meta")
    k = torch.empty(1, 64, 1, 64, device="meta")
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k, k)
    lse = torch.empty(1, 2, 64, device="meta")
    with pytest.raises(ValueError):
        fa.flash_bwd(q, k, k, q, lse, q)
