"""The port's public surface held to the JAX package's.

For the package and every module of ``lightkrylov_tpu`` that
``pkgutil.walk_packages`` yields, the counterpart
``lightkrylov_tpu_torch.<same path>`` must carry:

(a) the module itself;
(b) every name in the JAX module's ``__all__`` (its public names defined
    there where it has none);
(c) every public method, property and class attribute of every public class;
(d) every parameter of every public function, method and constructor, under
    the same name and with an equal default (dtypes compared by name,
    ``jnp.float32`` with ``torch.float32``).

Classes and functions are walked in the module that defines them; a
re-export is checked by name.  A deliberate difference is an entry of
``LEFT_OUT`` (left out, with its reason and the ROADMAP "Porting
conventions" bullet it falls under) or of ``RENAMED`` (the counterpart
under another name or default, whose existence is still checked).
``test_surface_tables_are_not_stale`` fails on an entry that no longer names
a difference.  The cases at the end hold the timing layer's and
``SolverMetadata``'s methods to the JAX package's on one fake clock.
"""

import dataclasses
import functools
import importlib
import inspect
import logging
import pkgutil
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import lightkrylov_tpu as lk  # noqa: E402
import lightkrylov_tpu_torch as lt  # noqa: E402
from lightkrylov_tpu.utils import options as joptions  # noqa: E402
from lightkrylov_tpu.utils import timer as jtimer  # noqa: E402
from lightkrylov_tpu_torch.utils import options as toptions  # noqa: E402
from lightkrylov_tpu_torch.utils import timer as ttimer  # noqa: E402

_KEYS = ("JAX's random key; the port draws from an explicit torch.Generator "
         "(ROADMAP Porting conventions: JAX interfaces replaced by torch's, random keys)")
_PREFIX = ("static-shape prefix chunking of the basis reductions; the port reduces "
           "over the filled columns (ROADMAP Porting conventions: TPU workarounds "
           "left out, the *_prefix reductions)")
_MESH = ("a jax.sharding mesh argument; the port's mesh is a torch.distributed group "
         "(ROADMAP Porting conventions: JAX interfaces replaced by torch's, the mesh)")
_DISTRIBUTED = ("a jax.distributed.initialize argument; the port's comm_setup takes "
                "torch.distributed's (ROADMAP Porting conventions: JAX interfaces "
                "replaced by torch's, the mesh)")
_SHARDING = ("a jax.sharding re-export; the port's partition is fixed rows "
             "(ROADMAP Porting conventions: JAX interfaces replaced by torch's, the mesh)")
_ORBAX = ("Orbax checkpoints; torch.distributed.checkpoint takes their place "
          "(ROADMAP Porting conventions: TPU workarounds left out, Orbax)")
_PALLAS = ("the Pallas kernel tier; the port's kernels live in ops.stencil and ops.spmv "
           "(ROADMAP Porting conventions: JAX interfaces replaced by torch's, the kernel tier)")
_BLOCK_SHAPE = ("bell_from_scipy's block shape: left as None, a card takes the one of "
                "ops.spmv.FITTED_SHAPES that stores fewer bytes, any other device the TPU's "
                "8 x 128 (ROADMAP Porting conventions: TPU workarounds left out, the 8 x 128 "
                "default block on a card)")
_VMEM = ("the TPU's VMEM tiling and dispatch; the CUDA kernels pick their own "
         "geometry (ROADMAP Porting conventions: TPU workarounds left out, the v5e "
         "VMEM dispatch)")

#: What the port leaves out on purpose: ``"module:qualname[:param]"`` (the
#: module relative to the package, ``__init__`` for the package) -> reason.
LEFT_OUT = {
    "krylov.gram_schmidt:orthogonalize_against_basis:k": _PREFIX,
    "krylov.gram_schmidt:orthogonalize_against_basis:chunk": _PREFIX,
    "krylov.gram_schmidt:double_gram_schmidt_step:k": _PREFIX,
    "krylov.gram_schmidt:double_gram_schmidt_step:chunk": _PREFIX,
    "ops:pallas": _PALLAS + "; the port's ops package is that tier itself",
    "ops.pallas:auto_poisson2d": _VMEM,
    "ops.pallas.stencil:effective_tile": _VMEM,
    "ops.pallas.stencil:PallasPoisson2D.__init__:vmem_budget": _VMEM,
    "ops.pallas.stencil:PallasPoisson2D.tile_effective": _VMEM,
    "ops.pallas.stencil:PallasPoisson2D.__init__:interpret": (
        "Pallas interpret mode; a wrapper runs its kernel's plain version on a CPU "
        "tensor (ROADMAP Porting conventions: JAX interfaces replaced by torch's, "
        "the kernel tier)"),
    "parallel:P": _SHARDING,
    "parallel:NamedSharding": _SHARDING,
    "parallel.mesh:P": _SHARDING,
    "parallel.mesh:NamedSharding": _SHARDING,
    "parallel.mesh:comm_setup:coordinator_address": _DISTRIBUTED,
    "parallel.mesh:comm_setup:num_processes": _DISTRIBUTED,
    "parallel.mesh:comm_setup:process_id": _DISTRIBUTED,
    "parallel.mesh:make_mesh:n_devices": _MESH,
    "parallel.mesh:make_mesh:axis_name": _MESH,
    "parallel.mesh:make_mesh:devices": _MESH,
    "parallel.mesh:distribute:spec": _MESH,
    "parallel.mesh:shard_rows:axis_name": _MESH,
    "parallel.stencil:ShardedPoisson2D.__init__:interpret": (
        "Pallas interpret mode; a wrapper runs its kernel's plain version on a CPU "
        "tensor (ROADMAP Porting conventions: JAX interfaces replaced by torch's, "
        "the kernel tier)"),
    "utils.checkpoint:save_checkpoint_orbax": _ORBAX,
    "utils.checkpoint:load_checkpoint_orbax": _ORBAX,
    "utils.linalg:to_host": ("the relay's host copy of complex arrays (ROADMAP Porting "
                             "conventions: TPU workarounds left out, to_host)"),
    "vectors:default_key": ("a host-built PRNG key (ROADMAP Porting conventions: TPU "
                            "workarounds left out, default_key)"),
}

#: Counterparts under another name: a module -> the port's module, a name ->
#: the port's name, a parameter -> (the port's name, its default), each with
#: its reason.
RENAMED = {
    "ops.pallas": ("ops", _PALLAS),
    "ops.pallas.stencil": ("ops.stencil", _PALLAS),
    "ops.pallas.spmv": ("ops.spmv", _PALLAS),
    "ops.pallas:PallasPoisson2D": ("CudaPoisson2D", _PALLAS),
    "ops.pallas.stencil:PallasPoisson2D": ("CudaPoisson2D", _PALLAS),
    "ops.pallas.spmv:bell_from_scipy:bm": (("bm", None), _BLOCK_SHAPE),
    "ops.pallas.spmv:bell_from_scipy:bn": (("bn", None), _BLOCK_SHAPE),
    "parallel.stencil:ShardedPoisson2D.__init__:kernel": (
        ("kernel", "cuda"),
        "JAX's 'xla'/'pallas' are the port's 'plain'/'cuda', the kernel the default "
        "(ROADMAP Porting conventions: JAX interfaces replaced by torch's, the kernel tier)"),
    **{f"{fn}:key": (("generator", None), _KEYS) for fn in (
        "krylov.arnoldi:arnoldi_block", "krylov.arnoldi:arnoldi_block_step",
        "krylov.qr:qr", "krylov.qr:qr_pivoted", "krylov.utilities:orthonormalize_basis",
        "solvers.eigs:eigs", "solvers.eighs:eighs", "solvers.svds:svds")},
    **{f"{fn}:key": (("generator", inspect.Parameter.empty), _KEYS) for fn in (
        "krylov.utilities:initialize_random_orthonormal_basis",
        "vectors:verify_vector_axioms")},
}


def _jax_modules():
    # ``native._bell_assembler`` is the JAX package's compiled assembler, a
    # shared library loaded by ctypes, not a Python module: it has no
    # surface to compare (the port builds its own copy of the source).
    names = [m.name for m in pkgutil.walk_packages(lk.__path__, prefix="lightkrylov_tpu.")]
    return ["lightkrylov_tpu"] + [n for n in names if n != "lightkrylov_tpu.native._bell_assembler"]


def _rel(modname):
    return "__init__" if modname == "lightkrylov_tpu" else modname[len("lightkrylov_tpu."):]


def _port_module(rel):
    return "lightkrylov_tpu_torch" if rel == "__init__" else "lightkrylov_tpu_torch." + rel


def _public_names(mod):
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n, v in vars(mod).items()
            if not n.startswith("_") and getattr(v, "__module__", None) == mod.__name__]


def _norm_default(v):
    """A default in a form both packages share: dtypes by name, dataclass
    instances by class name and fields."""
    if isinstance(v, torch.dtype):
        return ("dtype", str(v).rsplit(".", 1)[-1])
    if isinstance(v, np.dtype) or (isinstance(v, type)
                                   and v.__module__.split(".")[0] in ("jax", "numpy")):
        return ("dtype", np.dtype(v).name)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__, tuple((f.name, _norm_default(getattr(v, f.name)))
                                        for f in dataclasses.fields(v)))
    return v


def _params(fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return {p.name: _norm_default(p.default) for p in sig.parameters.values()
            if p.name not in ("self", "cls")}


def _class_members(cls):
    """Public members that a class of the JAX package defines, inherited
    from the package's own bases too."""
    members = {}
    for base in reversed(cls.__mro__):
        if getattr(base, "__module__", "").startswith("lightkrylov_tpu"):
            members.update((n, v) for n, v in vars(base).items() if not n.startswith("_"))
    return members


def _has_member(cls, name):
    if hasattr(cls, name):
        return True
    return dataclasses.is_dataclass(cls) and name in {f.name for f in dataclasses.fields(cls)}


class _Walk:
    """The differences of one JAX module, and the RENAMED entries it used
    (an entry is used only where the port lacks the JAX name, or for a
    parameter its default)."""

    def __init__(self, modname):
        self.diffs, self.renames = [], set()
        self.rel = _rel(modname)
        jmod = importlib.import_module(modname)
        prel = self._rename(self.rel, lambda: not _importable(_port_module(self.rel)), self.rel)
        try:
            pmod = importlib.import_module(_port_module(prel))
        except ImportError:
            self.diffs.append(self.rel)
            return
        for name in _public_names(jmod):
            key = f"{self.rel}:{name}"
            pname = self._rename(key, lambda: not hasattr(pmod, name), name)
            if not hasattr(pmod, pname):
                self.diffs.append(key)
                continue
            jobj, pobj = getattr(jmod, name), getattr(pmod, pname)
            if getattr(jobj, "__module__", None) != modname:
                continue  # a re-export: its home module walks it
            if inspect.isclass(jobj):
                self._params(f"{key}.__init__", jobj, pobj)
                for mname, member in _class_members(jobj).items():
                    if not _has_member(pobj, mname):
                        self.diffs.append(f"{key}.{mname}")
                    elif inspect.isfunction(member) or isinstance(member, (staticmethod, classmethod)):
                        self._params(f"{key}.{mname}", getattr(jobj, mname), getattr(pobj, mname))
            elif inspect.isfunction(jobj):
                self._params(key, jobj, pobj)

    def _rename(self, key, port_lacks_it, default):
        if key in RENAMED and port_lacks_it():
            self.renames.add(key)
            return RENAMED[key][0]
        return default

    def _params(self, key, jfn, pfn):
        jp, pp = _params(jfn), _params(pfn)
        if jp is None or pp is None:
            return
        for name, default in jp.items():
            pkey = f"{key}:{name}"
            pname, pdefault = self._rename(
                pkey, lambda: name not in pp or pp[name] != default, (name, default))
            if pname not in pp or pp[pname] != _norm_default(pdefault):
                self.diffs.append(pkey)


def _importable(name):
    try:
        importlib.import_module(name)
        return True
    except ImportError:
        return False


@functools.lru_cache(maxsize=None)
def _walk(modname):
    return _Walk(modname)


@pytest.mark.parametrize("modname", _jax_modules())
def test_port_module_has_the_jax_surface(modname):
    w = _walk(modname)
    missing = [d for d in w.diffs if d not in LEFT_OUT]
    assert not missing, f"the port lacks these (port them, or give LEFT_OUT a reason): {missing}"


def test_surface_tables_are_not_stale():
    walks = [_walk(m) for m in _jax_modules()]
    diffs = {d for w in walks for d in w.diffs}
    used = {r for w in walks for r in w.renames}
    stale = sorted(k for k in LEFT_OUT if k not in diffs)
    assert not stale, f"LEFT_OUT names what JAX no longer has or the port now has: {stale}"
    stale = sorted(k for k in RENAMED if k not in used)
    assert not stale, f"RENAMED names what JAX no longer has or the port has unrenamed: {stale}"
    assert all(isinstance(r, str) and "Porting conventions" in r
               for r in [*LEFT_OUT.values(), *(v[1] for v in RENAMED.values())])


# -- the timing layer and SolverMetadata against the JAX package's -----------


class _FakeClock:
    """``time.perf_counter`` stand-in: each call advances by the next of a
    fixed list of intervals, so two runs of one sequence read alike."""

    STEPS = (1.0, 2.5, 0.25, 4.0, 0.5, 3.0, 1.5, 0.75, 2.0, 0.125)

    def __init__(self):
        self.now, self.calls = 10.0, 0

    def __call__(self):
        self.now += self.STEPS[self.calls % len(self.STEPS)]
        self.calls += 1
        return self.now


def _timer_state(t):
    return (t.etime, t.tmin, t.tmax, t.count, t.running, list(t.history))


def _run_on_clock(monkeypatch, fn):
    monkeypatch.setattr(time, "perf_counter", _FakeClock())
    return fn()


def test_timer_matches_jax_on_a_fake_clock(monkeypatch):
    assert jtimer.time is time and ttimer.time is time

    def sequence(Timer):
        t = Timer("t")
        states = []
        for op, arg in [("start", None), ("stop", None), ("start", None), ("pause", None),
                        ("start", None), ("start", None), ("stop", None), ("stop", None),
                        ("reset", True), ("reset", True), ("start", None), ("pause", None),
                        ("start", None), ("stop", None), ("start", None), ("reset", True),
                        ("start", None), ("stop", None), ("reset", False)]:
            getattr(t, op)() if arg is None else t.reset(soft=arg)
            states.append((op, _timer_state(t), t.avg))
        return states

    jstates = _run_on_clock(monkeypatch, lambda: sequence(jtimer.Timer))
    tstates = _run_on_clock(monkeypatch, lambda: sequence(ttimer.Timer))
    assert tstates == jstates
    # the sequence reaches every branch: a paused interval, two archived
    # records (a soft reset of a running timer stops it), a hard wipe
    histories = [s[1][5] for s in jstates if s[0] == "reset"]
    assert histories[:2] == [[(9.5, 2.5, 3.0, 2)]] * 2
    assert histories[2][1] == (0.875, 0.125, 0.125, 1) and histories[3] == []
    assert jstates[-1][1] == (0.0, float("inf"), 0.0, 0, False, [])


def _watch_run(mod):
    w = mod.Watch("w")
    for name, group in [("a", "solvers"), ("b", "solvers"), ("c", "user")]:
        w.add_timer(name, group)
    for name in ("a", "b", "c", "a"):
        w.timer(name).start()
        w.timer(name).stop()
    w.remove_timer("b")
    w.remove_timer("missing")
    after_remove = (w.summary(), sorted(w._timers), {g: list(n) for g, n in w._groups.items()})
    w.reset_all()
    soft = {n: _timer_state(t) for n, t in w._timers.items()}
    w.timer("c").start()
    w.timer("c").stop()
    summary_soft = w.summary()
    w.reset_all(soft=False)
    hard = {n: _timer_state(t) for n, t in w._timers.items()}
    return after_remove, soft, summary_soft, hard, w


def test_watch_matches_jax_on_a_fake_clock(monkeypatch):
    jrun = _run_on_clock(monkeypatch, lambda: _watch_run(jtimer))
    trun = _run_on_clock(monkeypatch, lambda: _watch_run(ttimer))
    assert trun[:4] == jrun[:4]
    summary, names, groups = trun[0]
    assert names == ["a", "c"] and groups == {"solvers": ["a"], "user": ["c"]}
    lines = summary.splitlines()
    assert any(ln.startswith("  a ") for ln in lines)
    assert not any(ln.startswith("  b ") for ln in lines)
    assert all(s[3] == 0 and len(s[5]) == 1 for s in trun[1].values())
    assert all(s[3] == 0 and s[5] == [] for s in trun[3].values())


def test_summary_skips_a_timer_removed_behind_its_group():
    """A timer dropped from the registry but still named in a group (as
    JAX's guard allows) is skipped, not looked up."""
    for mod in (jtimer, ttimer):
        w = mod.Watch("w")
        w.add_timer("x", "g").start()
        w.timer("x").stop()
        del w._timers["x"]
        assert w.summary() == "== w timing summary =="


def test_print_summary_reaches_the_port_logger(monkeypatch, caplog):
    w = _run_on_clock(monkeypatch, lambda: _watch_run(ttimer))[4]
    w.timer("c").start()
    w.timer("c").stop()
    with caplog.at_level(logging.INFO, logger="lightkrylov_tpu_torch"):
        w.print_summary()
    records = [r for r in caplog.records if r.name == "lightkrylov_tpu_torch"]
    assert [r.getMessage() for r in records] == [w.summary()]
    assert records[0].levelno == logging.INFO


def test_solver_metadata_reset_matches_jax():
    def run(mod):
        m = mod.SolverMetadata(converged=True, n_iter=7, n_inner=30, info=-1,
                               residuals=np.linspace(1.0, 0.1, 30))
        m.reset()
        return m

    jm, tm = run(joptions), run(toptions)
    for f in dataclasses.fields(jm):
        np.testing.assert_array_equal(getattr(tm, f.name), getattr(jm, f.name))
    assert tm.history.shape == jm.history.shape == (0,)
    assert (tm.converged, tm.n_iter, tm.n_inner, tm.info) == (False, 0, 0, 0)


def test_ginzburg_landau_real_rmatvec_takes_y_by_keyword():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, 16))
    ref = np.asarray(lk.models.GinzburgLandauReal(16, dtype=jnp.float64).rmatvec(y=jnp.asarray(u)))
    got = lt.models.GinzburgLandauReal(16, dtype=torch.float64, device="cpu").rmatvec(y=torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), ref, rtol=lk.constants.rtol(np.float64),
                               atol=lk.constants.atol(np.float64))
