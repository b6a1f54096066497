"""The C entry points of the port's CUDA sources against the ctypes argtypes
its wrappers set.

Every ``extern "C"`` function in ``kuberay_tpu_torch/csrc/*.cu`` is parsed
from the source, and each wrapper module's ``ARGTYPES`` table (what its
loader from ``ops/_build.py``'s ``bind`` hands ctypes) is held to it
position by position: the same
count, and a pointer, an int or a float at every place.  ctypes passes
what it is told, so a mismatch would only show on the card, as a cut
pointer or a misread argument.  Runs on the CPU: nothing is built.
"""

import ctypes
import re
from pathlib import Path

import pytest

from kuberay_tpu_torch.ops import attention as fa
from kuberay_tpu_torch.ops import decode_attention as da
from kuberay_tpu_torch.ops import paged_attention as pa
from kuberay_tpu_torch.ops import ring_attention as ra
from kuberay_tpu_torch.ops import rmsnorm as rn

CSRC = Path(__file__).resolve().parents[1] / "kuberay_tpu_torch" / "csrc"
MODULES = (fa, ra, da, pa, rn)
_ENTRY = re.compile(r'extern\s+"C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)')
_KIND = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
         ctypes.c_float: "float"}


def _kind(param: str) -> str:
    """'ptr', 'int' or 'float' for one C parameter declaration."""
    if "*" in param:
        return "ptr"
    words = param.replace("const", " ").split()
    if words[:1] in (["int"], ["float"]):
        return words[0]
    raise AssertionError(f"unexpected C parameter {param!r}")


def c_entries() -> dict:
    """{(library, name): (return type, [kind of each parameter])}."""
    out = {}
    for path in sorted(CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", path.read_text())
        for ret, name, params in _ENTRY.findall(text):
            out[(path.stem, name)] = (
                ret, [_kind(p) for p in params.split(",") if p.strip()])
    return out


def bindings() -> dict:
    """{(library, name): [kind of each argtype]} over the wrapper modules."""
    out = {}
    for mod in MODULES:
        for name, types in mod.ARGTYPES.items():
            key = (mod.LIBRARY, name)
            assert key not in out, f"{key} bound twice"
            out[key] = [_KIND[t] for t in types]
    return out


ENTRIES = c_entries()


def test_every_source_has_entry_points_and_every_binding_a_source():
    assert {lib for lib, _ in ENTRIES} == {
        p.stem for p in CSRC.glob("*.cu")}
    assert set(bindings()) == set(ENTRIES)


@pytest.mark.parametrize("lib,name", sorted(ENTRIES),
                         ids=[f"{lib}:{name}" for lib, name in
                              sorted(ENTRIES)])
def test_argtypes_match_the_c_signature(lib, name):
    ret, kinds = ENTRIES[(lib, name)]
    bound = bindings().get((lib, name))
    assert ret == "int", "every entry point returns an int (ctypes restype)"
    assert bound is not None, f"no wrapper binds {lib}:{name}"
    assert len(bound) == len(kinds), (bound, kinds)
    for i, (b, k) in enumerate(zip(bound, kinds)):
        assert b == k, f"argument {i}: ctypes {b}, C {k}"


def test_the_parser_reads_pointers_ints_and_floats():
    ret, kinds = ENTRIES[("flash_attention", "flash_fwd_bf16")]
    assert kinds == ["ptr"] * 5 + ["int"] * 7 + ["float", "ptr"]
    assert _kind("const void* q") == "ptr" and _kind("int B") == "int"
    with pytest.raises(AssertionError):
        _kind("double x")
