"""Build the port's CUDA sources with ``nvcc`` at first use; load with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``_build/lib<name>-<hash>.so`` (the directory is git-ignored).  The
hash covers the source, every header in ``csrc/`` and the flags, so an
edited source rebuilds and an unchanged one loads the library already
there.  No PyTorch headers are included: a plain-C source builds in
seconds, where one that includes ``torch/extension.h`` takes minutes.

Only the sources in this package are built.  A failed build raises with
the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], Any] = {}

# The ctypes kinds of the entry points' parameters, for the wrappers'
# ARGTYPES tables.
PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                           f"({home}); the CUDA kernels cannot be built")
    return str(path)


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] | None = None) -> List[Path]:
    """Compile every named source (default: all of ``csrc/*.cu``) that has
    no up-to-date library yet, one ``nvcc`` per source, all started
    together.  Returns the library paths.  The compiler's output (with
    ``-Xptxas -v``'s register and shared-memory report) is kept beside
    each library as ``.log``."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    targets = [(n, _target(n)) for n in names]
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in targets:
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [out for _, out in targets]


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path, = build_all([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def bind(library: str, argtypes: Dict[str, list]) -> Callable[[str], Any]:
    """A loader of the C entry points of ``csrc/<library>.cu``: called with
    a name, it returns that function, built on first use, with
    ``argtypes[name]`` and an int (cudaError_t) result.  Nothing is built
    until then."""
    def fn(name: str):
        f = _fns.get((library, name))
        if f is None:
            f = getattr(load_library(library), name)
            f.argtypes = argtypes[name]
            f.restype = ctypes.c_int
            _fns[library, name] = f
        return f
    return fn
