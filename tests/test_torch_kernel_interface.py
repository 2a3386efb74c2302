"""The C interface between the ``ops`` modules and ``csrc/*.cu``, read on
the CPU.

Each ``ops`` module declares the C entries it calls, with their parameters
(:class:`lightkrylov_tpu_torch.ops._build.Entries`).  ``ctypes`` cannot see
a prototype: a declaration with a parameter too many or too few, or a
``long long`` declared as an ``int``, fails only on the card or corrupts
data there without an error.  So every declaration is held here to the
``extern "C"`` prototype of its name, and every entry of the sources to
exactly one declaration.
"""

import ctypes
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from lightkrylov_tpu_torch.ops import _build, cg, gmres, hessenberg, probes, spmv, stencil

MODULES = (stencil, spmv, probes, hessenberg, cg, gmres)
CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"


def _letter(param: str) -> str:
    """A C parameter's letter in :data:`_build.ARG_TYPES`."""
    if "*" in param:
        return "p"
    kind = " ".join(param.replace("const ", "").split()[:-1])
    return {"int": "i", "long long": "l", "double": "d"}[kind]


def _prototypes() -> dict[str, tuple[str, str]]:
    """Every entry defined in an ``extern "C"`` block of ``csrc/*.cu``:
    name -> (source, its parameters' letters)."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        blocks = re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', text, re.S)
        assert len(blocks) == text.count('extern "C" {'), f"{src.name}: an unclosed extern block"
        for block in blocks:
            for name, params in re.findall(r"^[\w ]+\**\s*(lk_\w+)\(([^)]*)\)\s*\{", block, re.M):
                params = [p for p in params.split(",") if p.strip() not in ("", "void")]
                assert name not in out, f"{name} is defined twice"
                out[name] = (src.name, "".join(_letter(p) for p in params))
    return out


PROTOTYPES = _prototypes()
DECLARED = [(m.__name__.rsplit(".", 1)[1], name, params)
            for m in MODULES for name, params in m.ENTRIES.declared.items()]


def test_the_sources_define_entries():
    assert len(PROTOTYPES) > len(MODULES) and "lk_error_string" in PROTOTYPES


@pytest.mark.parametrize("module,name,params", DECLARED, ids=[d[1] for d in DECLARED])
def test_declared_entry_matches_its_prototype(module, name, params):
    assert name in PROTOTYPES, f"ops/{module}.py declares {name}, which csrc/*.cu does not define"
    src, want = PROTOTYPES[name]
    got = params.replace(" ", "")
    assert len(got) == len(want), f"{name}: {len(got)} parameters declared, {len(want)} in {src}"
    assert got == want, f"{name}: declared {got}, {src} has {want}"


@pytest.mark.parametrize("name", sorted(PROTOTYPES))
def test_every_entry_is_declared_by_one_module(name):
    owners = [m.__name__ for m in MODULES if name in m.ENTRIES.declared]
    if name == "lk_error_string":  # declared by _build itself
        assert owners == []
    else:
        assert len(owners) == 1, f"{name} is declared by {owners or 'no ops module'}"


class _FakeLibrary:
    """Two entries and the error text, as a loaded library has them."""

    def __init__(self):
        self.lk_a, self.lk_b = SimpleNamespace(), SimpleNamespace()

    @staticmethod
    def lk_error_string(err):
        return b"an error's text"


def test_entries_are_bound_once_a_handle():
    entries = _build.Entries({"lk_a": "pi l", "lk_b": "d"})
    lib, other = _FakeLibrary(), _FakeLibrary()
    bound = entries.on(lib)
    assert bound["lk_a"] is lib.lk_a and bound["lk_b"] is lib.lk_b
    assert lib.lk_a.argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
    assert lib.lk_b.argtypes == [ctypes.c_double] and lib.lk_a.restype is ctypes.c_int
    lib.lk_a.argtypes = None
    assert entries.on(lib) is bound and lib.lk_a.argtypes is None
    assert entries.on(other)["lk_a"] is other.lk_a
    assert other.lk_a.argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]


def test_dtype_tag_and_error_decode():
    assert [_build.dtype_tag(t, "k") for t in (torch.float32, torch.float64)] == ["f32", "f64"]
    with pytest.raises(TypeError, match=r"^k kernel: dtype torch.float16 not supported"):
        _build.dtype_tag(torch.float16, "k kernel")
    _build.check(_FakeLibrary(), 0, "k")
    with pytest.raises(RuntimeError, match=r"^k kernel launch failed: CUDA error 7 \(an error's"):
        _build.check(_FakeLibrary(), 7, "k kernel launch")
