"""What one run of a cell is: its files, found by name, and its context.

A cell ``<name>`` is ``cells/<name>.json``; it names its configuration
(``configs/<config>.json``, whose ``port.family`` names
``families/<family>.py``), its traffic mix (``traffic/<mix>.json``, whose
``kind`` names ``traffic/<kind>.py``) and its driver
(``drivers/<driver>.py``).  A metric ``<metric>`` is read by
``metrics/<metric>.py``.  ``BENCHMARK.json`` at the root of the checkout
says which metrics a cell reports.  Nothing here changes when a cell, a
configuration, a family, a mix, a traffic kind, a driver or a metric is
added.

A cell or mix key that its driver or traffic kind does not read is
refused before anything runs (each names the keys it reads), so a setting
in a file is always a setting that is run.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"

# Top-level module names no run may hold (compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "kuberay_tpu")


def pin_caches() -> None:
    """Point the compile caches the port uses at fixed folders inside the
    checkout, before anything imports Triton.  The port's nvcc builds go
    to its own ``kuberay_tpu_torch/_build``."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def read_json(path: Path) -> Dict:
    return json.loads(path.read_text())


def benchmark() -> Dict:
    return read_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class RunContext:
    name: str
    cell: Dict
    config: Dict
    mix: Dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = 0.0
    # Control runs and fault tests only (never set by a measurement run):
    # ``engine``, keyword arguments over the cell's engine (the control's
    # weight_quant); hooks on the engine or the step.
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)


def load_cell(name: str) -> Dict:
    path = HERE / "cells" / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"no cell {name!r} ({path} is missing)")
    return read_json(path)


# Keys every cell carries, besides those its driver reads.
CELL_KEYS = frozenset({"name", "config", "traffic", "driver", "chips",
                       "why"})


def check_keys(ctx: RunContext) -> None:
    """Refuse a cell or mix key that nothing reads."""
    from portbench.traffic import generate

    extra = set(ctx.cell) - CELL_KEYS - set(driver(
        ctx.cell["driver"]).CELL_KEYS)
    if extra:
        raise SystemExit(f"cell {ctx.name}: keys {sorted(extra)} are read "
                         f"by nothing (driver {ctx.cell['driver']!r})")
    generate.check_keys(ctx.mix)


def context(name: str, seed: int, seconds: float, trace: bool,
            t_start: float, device: str = "cuda") -> RunContext:
    cell = load_cell(name)
    config = read_json(HERE / "configs" / f"{cell['config']}.json")
    mix = read_json(HERE / "traffic" / f"{cell['traffic']}.json")
    ctx = RunContext(name, cell, config, mix, seed, seconds, trace,
                     device, t_start)
    check_keys(ctx)
    return ctx


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise SystemExit(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str) -> ModuleType:
    return _module(HERE / "drivers" / f"{name}.py", f"portbench_driver_{name}")


def family(config: Dict) -> ModuleType:
    """The model family a configuration names (``port.family``)."""
    name = config["port"]["family"]
    return _module(HERE / "families" / f"{name}.py",
                   f"portbench_family_{name}")


def reader(metric: str) -> ModuleType:
    return _module(HERE / "metrics" / f"{metric}.py",
                   "portbench_metric_" + metric.replace(".", "_"))


def metrics_of(bench: Dict, workload: str, trace: bool) -> List[Dict]:
    """The end-to-end (``trace`` false) or per-layer metrics of a cell."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules(modules) -> List[str]:
    return sorted({n for n in modules if n.split(".")[0] in FORBIDDEN})


def read_metrics(bench: Dict, ctx: RunContext, record: Dict
                 ) -> Dict[str, Dict[str, Any]]:
    """Every metric of the cell that its reader finds something for; an
    end-to-end metric must always be found."""
    out: Dict[str, Dict[str, Any]] = {}
    for m in metrics_of(bench, ctx.name, ctx.trace):
        value: Optional[float] = reader(m["name"]).read(record)
        if value is None:
            if not ctx.trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   f"nothing")
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
