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
from kuberay_tpu_torch.ops import paged_attention as pa
from kuberay_tpu_torch.ops import rmsnorm as rn
from kuberay_tpu_torch.parallel.mesh import LocalRing
from kuberay_tpu_torch.serve import engine, paged_engine, server
from kuberay_tpu_torch.train import checkpoint, launcher, train_step

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "kuberay_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "tensorstore", "kuberay_tpu")


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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paged_engine.PagedServeEngine(cfg, params, max_slots=1, max_len=16,
                                      block_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.ServeEngine(cfg, params, max_slots=1, max_len=16,
                           kv_quant="int8")
    for extra in (["--paged"], ["--paged", "--kv-quant", "int8"],
                  ["--kv-quant", "int8"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            server.main(["--model", "llama_tiny", "--port", "0", *extra])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--model", "llama_tiny", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.load_params_for_serving("no-such-checkpoint")
    init, _, _ = train_step.make_sharded_train_fns(
        cfg, train_step.TrainConfig(), LocalRing(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init()
    # Asked for the CPU, they run.
    init, _, _ = train_step.make_sharded_train_fns(
        cfg, train_step.TrainConfig(), LocalRing(4, "cpu"))
    assert init()["params"]["embed"].device.type == "cpu"
    eng = engine.ServeEngine(cfg, params, max_slots=1, max_len=16,
                             device="cpu")
    assert eng.device.type == "cpu"
    eng = paged_engine.PagedServeEngine(cfg, params, max_slots=1, max_len=16,
                                        block_size=8, device="cpu",
                                        kv_quant="int8")
    assert eng.cache["k"]["q"].device.type == "cpu"


def test_engine_rejects_params_on_another_device():
    cfg = llama.CONFIGS["llama_tiny"]
    params = llama.init_params(cfg, None, "meta")
    with pytest.raises(ValueError, match="params are on"):
        engine.ServeEngine(cfg, params, max_slots=1, max_len=16, device="cpu")


def test_kernel_modules_have_no_fallback():
    """No try/except in the kernel wrappers, the build or the rings: a CUDA
    tensor launches the kernel or raises."""
    for name in ("ops/rmsnorm.py", "ops/decode_attention.py",
                 "ops/paged_attention.py", "ops/attention.py",
                 "ops/ring_attention.py", "ops/_build.py",
                 "parallel/ring.py", "parallel/ring_kernel.py"):
        tree = ast.parse((ROOT / "kuberay_tpu_torch" / name).read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], name


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError):
        rn.rmsnorm(x, torch.empty(8, device="meta"))
    q = torch.empty(2, 4, 16, device="meta")
    c = torch.empty(2, 8, 2, 16, device="meta")
    with pytest.raises(ValueError):
        da.decode_attention(q, c, c, torch.empty(2, device="meta"))
    c8 = torch.empty(2, 8, 2, 16, dtype=torch.int8, device="meta")
    s8 = torch.empty(2, 2, 8, device="meta")
    with pytest.raises(ValueError):
        da.decode_attention_quant(q, c8, s8, c8, s8,
                                  torch.empty(2, device="meta"))
    pool = torch.empty(2, 32, 16, device="meta")
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, pool, pool, torch.empty(2, device="meta"),
                                  torch.empty(2, 4, device="meta"), 8)
    q = torch.empty(1, 64, 2, 64, device="meta")
    k = torch.empty(1, 64, 1, 64, device="meta")
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k, k)
    lse = torch.empty(1, 2, 64, device="meta")
    with pytest.raises(ValueError):
        fa.flash_bwd(q, k, k, q, lse, q)


def test_scan_covers_the_tier_and_mixtral_modules():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"kuberay_tpu_torch/serve/kv_tiers.py",
            "kuberay_tpu_torch/models/mixtral.py",
            "kuberay_tpu_torch/ops/moe_matmul.py",
            "kuberay_tpu_torch/serve/paged_engine.py"} <= names


def test_mixtral_and_tiered_engines_raise_without_a_card(monkeypatch):
    from kuberay_tpu_torch.models import mixtral
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = mixtral.CONFIGS["mixtral_tiny"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mixtral.init_params(cfg)
    params = mixtral.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.ServeEngine(cfg, params, max_slots=1, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paged_engine.PagedServeEngine(cfg, params, max_slots=1, max_len=16,
                                      block_size=8, host_blocks=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.main(["--model", "llama_tiny", "--port", "0", "--paged",
                     "--host-blocks", "8"])
    eng = paged_engine.PagedServeEngine(cfg, params, max_slots=1,
                                        max_len=16, block_size=8,
                                        device="cpu", host_blocks=4)
    assert eng.tiers is not None and eng.cache["k"].device.type == "cpu"


LAYOUT_MODULES = ("kuberay_tpu_torch/bench.py", "kuberay_tpu_torch/entry.py",
                  "kuberay_tpu_torch/runtime/profiler.py",
                  "kuberay_tpu_torch/parallel/spmd.py")
TEST_WORKERS = ("tests/torch_sp_worker.py", "tests/torch_mesh_worker.py")


def test_scan_covers_the_layout_modules_and_test_workers():
    """The multi-process layouts' modules are in the scan, and the test
    workers (processes that import torch and the port only) import nothing
    of JAX or the JAX package either."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert set(LAYOUT_MODULES) <= names
    bad = [(name, m) for name in TEST_WORKERS
           for m in _imported_modules(ast.parse((ROOT / name).read_text()))
           if m.split(".")[0] in FORBIDDEN]
    assert not bad


def test_layout_modules_catch_nothing():
    """No ``except`` in the layouts, the entry points or the bench: a
    collective or a launch that fails raises (the profiler hook answers
    {"error": ...} as the coordinator's does, and is left out)."""
    for name in LAYOUT_MODULES[:2] + ("kuberay_tpu_torch/parallel/spmd.py",
                                      "kuberay_tpu_torch/parallel/mesh.py"):
        tree = ast.parse((ROOT / name).read_text())
        assert not [n for n in ast.walk(tree)
                    if isinstance(n, ast.Try) and n.handlers], name


TP_SERVING_MODULES = ("kuberay_tpu_torch/serve/sharding.py",
                      "kuberay_tpu_torch/serve/multihost.py",
                      "kuberay_tpu_torch/serve/group_health.py",
                      "kuberay_tpu_torch/utils/quantiles.py")


def test_scan_covers_the_tp_serving_modules_and_their_worker():
    """The tensor-parallel serving modules are in the scan, and their test
    worker imports nothing of JAX or the JAX package either."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert set(TP_SERVING_MODULES) <= names
    tree = ast.parse((ROOT / "tests/torch_tp_serve_worker.py").read_text())
    assert not [m for m in _imported_modules(tree)
                if m.split(".")[0] in FORBIDDEN]


def test_tp_serving_paths_catch_nothing():
    """No ``except`` in the sharding and the lockstep engines: a failed
    collective or broadcast raises to the frontend, which degrades the
    group (no fallback to tp=1 or to the CPU)."""
    for name in TP_SERVING_MODULES[:2]:
        tree = ast.parse((ROOT / name).read_text())
        assert not [n for n in ast.walk(tree)
                    if isinstance(n, ast.Try) and n.handlers], name


def test_tp_server_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "a,b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.main(["--model", "llama_tiny", "--port", "0", "--tp", "2"])


LAST_MODULES = ("kuberay_tpu_torch/parallel/pipeline.py",
                "kuberay_tpu_torch/obs/profile.py",
                "kuberay_tpu_torch/obs/trace.py")


def test_scan_covers_the_pipeline_and_profile_modules_and_their_workers():
    """The pipeline, the profile and the tracer are in the scan, and the
    workers of the pipeline and tp-tier tests import nothing of JAX or
    the JAX package either."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert set(LAST_MODULES) <= names
    for name in ("tests/torch_pp_worker.py", "tests/torch_tp_tiers_worker.py"):
        tree = ast.parse((ROOT / name).read_text())
        assert not [m for m in _imported_modules(tree)
                    if m.split(".")[0] in FORBIDDEN], name


def test_pipeline_and_profile_catch_nothing():
    """No ``except`` in the pipeline's hops, the profile or the tracer: a
    failed exchange raises."""
    for name in LAST_MODULES:
        tree = ast.parse((ROOT / name).read_text())
        assert not [n for n in ast.walk(tree)
                    if isinstance(n, ast.Try) and n.handlers], name


def test_tiered_tp_server_raises_without_a_card(monkeypatch):
    """``--tp 2 --paged --host-blocks`` is no longer refused at parsing:
    it reaches the device check."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "a,b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.main(["--model", "llama_tiny", "--port", "0", "--tp", "2",
                     "--paged", "--host-blocks", "8"])
