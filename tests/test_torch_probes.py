"""The bandwidth probes' kernels and the probe path against the TPU probes.

The Pallas bodies of ``benchmarks/`` (P1-P7) live inside each script's
``main()``, so they are copied here from the cited lines and run in
interpret mode on the CPU, where the port's wrappers compute their plain
versions: the copies must be bit-equal to the input and to
``copy_reference``, the reduction within 1e-5 of each entry's sum of |x|.
Each ``lightkrylov_tpu_torch.probes`` module runs end to end on the CPU at a
tiny size.  The tests marked ``cuda`` hold each kernel to its plain version
and count its launches; they skip where there is no GPU, and import no JAX
(``python -m pytest --noconftest -m cuda tests/test_torch_probes.py``).
"""

import functools
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightkrylov_tpu_torch as lt
from lightkrylov_tpu_torch.ops import probes as P
from lightkrylov_tpu_torch.probes import (copy_shape, deep_buffer, manual_out, roofline,
                                          stencil_sweep, timing)

torch.set_num_threads(2)

TINY_LOOP = dict(min_diff=1e-3, iters0=2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)


@pytest.fixture
def pallas():
    """``(jax, jax.numpy, pallas, pallas.tpu)``."""
    import jax
    import jax.experimental.pallas as pl
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    return jax, jnp, pl, pltpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def seeded(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the TPU bodies, copied from benchmarks/ (interpret mode)


def tpu_copy(pallas, shape, block):
    """P1/P3/P6/P7: ``_copy_kernel`` on the grid of
    ``copy_shape_probe.py:47-69`` (1-D for row blocks, else 2-D)."""
    jax, jnp, pl, _ = pallas

    def _copy_kernel(x_ref, y_ref):
        y_ref[...] = x_ref[...]

    (ny, nx), (by, bx) = shape, block
    gy, gx = ny // by, nx // bx
    if gx == 1:
        return pl.pallas_call(
            _copy_kernel, grid=(gy,),
            in_specs=[pl.BlockSpec((by, nx), lambda i: (i, 0))],
            out_specs=pl.BlockSpec((by, nx), lambda i: (i, 0)),
            out_shape=jax.ShapeDtypeStruct(shape, jnp.float32), interpret=True)
    return pl.pallas_call(
        _copy_kernel, grid=(gy, gx),
        in_specs=[pl.BlockSpec((by, bx), lambda i, j: (i, j))],
        out_specs=pl.BlockSpec((by, bx), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct(shape, jnp.float32), interpret=True)


def tpu_reduce(pallas, n, rows, ny=None):
    """P2: ``_reduce_kernel`` of ``roofline_probe.py:109-124`` on ``(ny, n)``."""
    jax, jnp, pl, _ = pallas
    ny = ny or n

    def _reduce_kernel(x_ref, y_ref, *, rows, n):
        @pl.when(pl.program_id(0) == 0)
        def _():
            y_ref[:, :] = jnp.zeros_like(y_ref)
        part = x_ref[:, :].reshape(rows // 8, 8, n // 128, 128)
        y_ref[:, :] += jnp.sum(part, axis=(0, 2))

    return pl.pallas_call(
        functools.partial(_reduce_kernel, rows=rows, n=n), grid=(ny // rows,),
        in_specs=[pl.BlockSpec((rows, n), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((8, 128), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32), interpret=True)


def tpu_manual_copy(pallas, n, rows):
    """P4: ``_manual_kernel`` of ``manual_out_probe.py:69-126``."""
    jax, jnp, pl, pltpu = pallas
    nprog = n // rows

    def _manual_kernel(x_hbm, y_hbm, ib, ob, sin, sout):
        i = pl.program_id(0)
        two = jnp.int32(2)
        slot = jax.lax.rem(i, two)

        def in_copy(j, s):
            return pltpu.make_async_copy(
                x_hbm.at[pl.ds(pl.multiple_of(j * rows, rows), rows), :], ib.at[s], sin.at[s])

        def out_copy(j, s):
            return pltpu.make_async_copy(
                ob.at[s], y_hbm.at[pl.ds(pl.multiple_of(j * rows, rows), rows), :], sout.at[s])

        @pl.when(i == 0)
        def _():
            in_copy(i, slot).start()

        @pl.when(i + 1 < nprog)
        def _():
            in_copy(i + 1, jax.lax.rem(i + 1, two)).start()

        in_copy(i, slot).wait()

        @pl.when(i >= 2)
        def _():
            out_copy(i - 2, slot).wait()

        ob[slot] = ib[slot][...]
        out_copy(i, slot).start()

        @pl.when(i == nprog - 1)
        def _():
            @pl.when(nprog >= 2)
            def _():
                out_copy(i - 1, jax.lax.rem(i - 1, two)).wait()
            out_copy(i, slot).wait()

    return pl.pallas_call(
        _manual_kernel, grid=(nprog,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=jax.ShapeDtypeStruct((n, n), jnp.float32),
        scratch_shapes=[pltpu.VMEM((2, rows, n), jnp.float32),
                        pltpu.VMEM((2, rows, n), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,)), pltpu.SemaphoreType.DMA((2,))],
        interpret=True)


def tpu_deep_copy(pallas, n, depth, rows):
    """P5: ``make_copy(depth, rows)`` of ``deep_buffer_probe.py:38-102``."""
    jax, jnp, pl, pltpu = pallas
    nprog = n // rows

    def kern(x_hbm, y_hbm, ib, ob, sin, sout):
        i = pl.program_id(0)
        d = jnp.int32(depth)
        slot = jax.lax.rem(i, d)

        def in_copy(j, s):
            return pltpu.make_async_copy(
                x_hbm.at[pl.ds(pl.multiple_of(j * rows, rows), rows), :], ib.at[s], sin.at[s])

        def out_copy(j, s):
            return pltpu.make_async_copy(
                ob.at[s], y_hbm.at[pl.ds(pl.multiple_of(j * rows, rows), rows), :], sout.at[s])

        @pl.when(i == 0)
        def _():
            for j in range(depth):
                if j < nprog:
                    in_copy(jnp.int32(j), jnp.int32(j)).start()

        @pl.when((i + depth - 1 < nprog) & (i > 0))
        def _():
            in_copy(i + depth - 1, jax.lax.rem(i + depth - 1, d)).start()

        in_copy(i, slot).wait()

        @pl.when(i >= depth)
        def _():
            out_copy(i - depth, slot).wait()

        ob[slot] = ib[slot][...]
        out_copy(i, slot).start()

        @pl.when(i == nprog - 1)
        def _():
            for off in range(depth - 1, -1, -1):
                if nprog > off:
                    out_copy(i - off, jax.lax.rem(i - off + d, d)).wait()

    return pl.pallas_call(
        kern, grid=(nprog,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=jax.ShapeDtypeStruct((n, n), jnp.float32),
        scratch_shapes=[pltpu.VMEM((depth, rows, n), jnp.float32),
                        pltpu.VMEM((depth, rows, n), jnp.float32),
                        pltpu.SemaphoreType.DMA((depth,)), pltpu.SemaphoreType.DMA((depth,))],
        interpret=True)


# each TPU copy case's aspect at a shrunk size: (label, shape, block)
COPY_CASES = [
    ("P1_rows", (256, 256), (16, 256)),
    ("P3_rows", (256, 256), (8, 256)),
    ("P6_rows", (256, 256), (64, 256)),
    ("P7_blk_wide", (128, 1024), (16, 256)),
    ("P7_blk_narrow", (256, 256), (64, 32)),
    ("P7_tall", (1024, 128), (64, 128)),
    ("ragged", (24, 136), (8, 68)),
]


@pytest.mark.parametrize("label,shape,block", COPY_CASES, ids=[c[0] for c in COPY_CASES])
def test_copy_tiles_matches_pallas_copy(pallas, label, shape, block):
    x = seeded(shape)
    want = np.asarray(tpu_copy(pallas, shape, block)(pallas[1].asarray(x)))
    got = P.copy_tiles(torch.from_numpy(x), block)
    assert np.array_equal(want, x)
    assert torch.equal(got, P.copy_reference(torch.from_numpy(x)))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("ny,n,rows", [(256, 256, 16), (64, 1024, 8), (1024, 128, 64)])
def test_reduce_8x128_matches_pallas_reduce(pallas, ny, n, rows):
    x = seeded((ny, n), seed=3)
    want = np.asarray(tpu_reduce(pallas, n, rows, ny)(pallas[1].asarray(x)))
    got = P.reduce_8x128(torch.from_numpy(x)).numpy()
    exact = x.astype(np.float64).reshape(ny // 8, 8, n // 128, 128).sum(axis=(0, 2))
    scale = np.abs(x.astype(np.float64)).reshape(ny // 8, 8, n // 128, 128).sum(axis=(0, 2))
    # f32 sums in two orders: each within 1e-5 of the entry's sum of |x|
    assert np.all(np.abs(got - exact) <= 1e-5 * scale)
    assert np.all(np.abs(want - exact) <= 1e-5 * scale)


@pytest.mark.parametrize("body,depth", [("P4", 2), ("P5", 2), ("P5", 3), ("P5", 4)])
def test_copy_ring_matches_pallas_manual_copy(pallas, body, depth):
    n, rows = 128, 16
    x = seeded((n, n), seed=depth)
    fn = tpu_manual_copy(pallas, n, rows) if body == "P4" else tpu_deep_copy(pallas, n, depth, rows)
    want = np.asarray(fn(pallas[1].asarray(x)))
    got = P.copy_ring(torch.from_numpy(x), depth, deep_buffer.ring_stage(rows))
    assert np.array_equal(want, x)
    assert np.array_equal(got.numpy(), want)


def test_reference_plain_versions():
    x = torch.from_numpy(seeded((16, 256)))
    y = P.copy_reference(x)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    s = P.reduce_8x128_reference(x)
    assert s.shape == (8, 128)
    assert torch.allclose(s[3, 5], x[3::8, 5::128].sum())


# ---------------------------------------------------------------------------
# wrappers: refusals, CPU path, launch geometry


@pytest.mark.parametrize("call,exc", [
    (lambda: P.copy_tiles(torch.ones(16, 256), (5, 256)), ValueError),
    (lambda: P.copy_tiles(torch.ones(16, 256), (16, 6)), ValueError),
    (lambda: P.copy_tiles(torch.ones(16, 256), (16, 96)), ValueError),
    (lambda: P.copy_tiles(torch.ones(256, 16).T, (16, 256)), ValueError),
    (lambda: P.copy_tiles(torch.ones(16, 256, dtype=torch.float64), (16, 256)), TypeError),
    (lambda: P.copy_tiles(torch.ones(4, 16, 256), (16, 256)), ValueError),
    (lambda: P.copy_ring(torch.ones(256, 16).T, 2, 1024), ValueError),
    (lambda: P.copy_ring(torch.ones(16, 256, dtype=torch.float16), 2, 1024), TypeError),
    (lambda: P.copy_ring(torch.ones(16, 256), 0, 1024), ValueError),
    (lambda: P.copy_ring(torch.ones(16, 256), 1, 1024), ValueError),
    (lambda: P.copy_ring(torch.ones(16, 256), 2, 1000), ValueError),
    (lambda: P.copy_ring(torch.ones(16, 256), 4, 64 * 1024), ValueError),
    (lambda: P.copy_ring(torch.ones(3), 2, 1024), ValueError),
    (lambda: P.reduce_8x128(torch.ones(12, 256)), ValueError),
    (lambda: P.reduce_8x128(torch.ones(16, 200)), ValueError),
    (lambda: P.reduce_8x128(torch.ones(256, 16).T), ValueError),
    (lambda: P.reduce_8x128(torch.ones(16, 256, dtype=torch.float64)), TypeError),
], ids=["tiles-block", "tiles-block-cols", "tiles-block-width-not-divisor", "tiles-strided",
        "tiles-f64", "tiles-3d", "ring-strided", "ring-f16", "ring-depth", "ring-depth1", "ring-stage16",
        "ring-smem", "ring-bytes16", "reduce-rows", "reduce-cols", "reduce-strided",
        "reduce-f64"])
def test_wrappers_refuse(call, exc):
    with pytest.raises(exc):
        call()


def test_cpu_calls_count_no_launch():
    x = torch.from_numpy(seeded((16, 256)))
    before = (P.copy_tiles.LAUNCHES, P.copy_ring.LAUNCHES, P.reduce_8x128.LAUNCHES)
    P.copy_tiles(x, (8, 256)), P.copy_ring(x, 2, 1024), P.reduce_8x128(x)
    assert (P.copy_tiles.LAUNCHES, P.copy_ring.LAUNCHES, P.reduce_8x128.LAUNCHES) == before


def test_tiles_geometry_gives_full_units_for_every_tpu_case():
    cases = [(s, b) for _, s, b in copy_shape.CASES]
    cases += [((8192, 8192), (rows, 8192)) for rows in stencil_sweep.ROWS]
    cases += [((4096, 4096), (roofline.ROWS, 4096)), ((8192, 8192), (manual_out.ROWS, 8192))]
    for (ny, nx), (by, bx) in cases:
        unit_rows, unit_cols, grid = P.tiles_geometry(ny, nx, by, bx)
        assert by % unit_rows == 0 and bx % unit_cols == 0 and unit_cols % 4 == 0
        assert unit_rows * unit_cols == P.UNIT_FLOATS
        assert grid == ny * nx // P.UNIT_FLOATS
    assert P.tiles_geometry(24, 136, 8, 68) == (8, 68, 6)


def test_ring_and_reduce_geometry():
    assert deep_buffer.cases() == [(d, r) for d in (2, 3, 4) for r in (64, 128, 256)]
    for depth, rows in deep_buffer.cases():
        assert depth * deep_buffer.ring_stage(rows) <= 192 * 1024 <= P.RING_SMEM_MAX
    assert P.ring_geometry(1000 * 36 * 4, 12288, 132) == (12, 12)
    assert P.ring_geometry(8192 * 8192 * 4, 12288, 132) == (21846, 132)
    assert P.reduce_grid(4096, 4096, 132) == 1056
    assert P.reduce_grid(16, 256, 132) == 4


# ---------------------------------------------------------------------------
# timing


def fake_clock(per_step, overhead):
    """A clock that advances ``per_step`` a step and ``overhead`` a sync."""
    now = [0.0]

    def step(v):
        now[0] += per_step
        return v

    def sync():
        now[0] += overhead

    return step, sync, lambda: now[0]


def test_timed_loop_valid_on_first_attempt():
    step, sync, clock = fake_clock(1e-3, 0.0)
    t, d = timing.timed_loop(step, torch.zeros(1), min_diff=0.05, iters0=4, clock=clock,
                             sync=sync)
    assert d["valid"] and d["attempt"] == 0 and d["iters"] == 51
    assert t == pytest.approx(1e-3)


def test_timed_loop_retries_until_the_difference_counts():
    # the pilot over-estimates a step (the sync's 0.1 s), so K is small and
    # t2 - t1 < 0.2 t2 twice; the third attempt's K makes it valid
    step, sync, clock = fake_clock(1e-3, 0.1)
    t, d = timing.timed_loop(step, torch.zeros(1), min_diff=0.05, iters0=4, clock=clock,
                             sync=sync)
    assert d["valid"] and d["attempt"] == 2 and d["iters"] == 124
    assert t == pytest.approx(1e-3)


def test_timed_loop_flags_invalid_and_never_clamps():
    step, sync, clock = fake_clock(1e-4, 10.0)
    t, d = timing.timed_loop(step, torch.zeros(1), min_diff=0.01, iters0=4, clock=clock,
                             sync=sync)
    assert not d["valid"] and d["attempt"] == 2
    assert t == pytest.approx(1e-4)
    assert d["t2"] - d["t1"] < 0.2 * d["t2"]


def test_datasheet_and_health_gate(tmp_path):
    assert timing.datasheet_bw("NVIDIA H100 80GB HBM3") == 3.35e12
    assert timing.datasheet_bw("NVIDIA H100 PCIe") == 2.0e12
    assert timing.datasheet_bw("TPU v5 lite") is None
    timing.health_gate("cpu", n=64)
    out = tmp_path / "probe.json"
    line = timing.emit({"probe": "x", "device_kind": "cpu"}, out)
    timing.emit({"probe": "y", "device_kind": "cpu"}, out)
    assert json.loads(line) == {"probe": "x", "device_kind": "cpu"}
    assert [json.loads(s)["probe"] for s in out.read_text().splitlines()] == ["x", "y"]


# ---------------------------------------------------------------------------
# the probe path on the CPU at tiny sizes


SHRUNK_CASES = [(label, (shape[0] // 32, shape[1] // 32), (max(1, block[0] // 32), block[1] // 32))
                for label, shape, block in copy_shape.CASES]

PROBE_RUNS = {
    "roofline": (roofline, dict(n=256, nb=64, nmm=64),
                 {"cuda_copy_GBs", "cuda_copy_valid", "linearity_ratio", "cuda_reduce_GBs",
                  "cuda_reduce3_GBs", "torch_stream_GBs", "torch_stencil_Gnnzs",
                  "cuda_stencil_Gnnzs", "matmul_bf16_TFLOPs", "matmul_f32_TFLOPs"}),
    "manual_out": (manual_out, dict(n=256),
                   {"managed_GBs", "managed_valid", "manual_GBs", "manual_valid"}),
    "deep_buffer": (deep_buffer, dict(n=256), {"cases"}),
    "stencil_sweep_8192": (stencil_sweep, dict(n=512),
                           {"copy_sweep", "cuda_copy_GBs", "torch_stream_GBs",
                            "torch_stencil_Gnnzs", "sweep"}),
    "copy_shape": (copy_shape, dict(cases=SHRUNK_CASES, control_n=256), {"cases"}),
}


@pytest.mark.parametrize("probe", list(PROBE_RUNS))
def test_probe_runs_end_to_end_on_cpu(probe):
    mod, sizes, keys = PROBE_RUNS[probe]
    res = json.loads(json.dumps(mod.run("cpu", **sizes, **TINY_LOOP)))
    assert res["probe"] == probe and res["device_kind"] == "cpu"
    assert keys <= set(res)
    if probe == "deep_buffer":
        assert [(c["depth"], c["rows"]) for c in res["cases"]] == deep_buffer.cases()
    if probe == "copy_shape":
        assert [c["label"] for c in res["cases"]] == [c[0] for c in copy_shape.CASES] + [
            "torch_add_256"]
    if probe == "stencil_sweep_8192":
        assert [c["rows"] for c in res["copy_sweep"]] == list(stencil_sweep.ROWS)


@pytest.mark.parametrize("mod", [roofline, manual_out, deep_buffer, stencil_sweep, copy_shape],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_probe_main_refuses_without_a_card(mod, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe would measure it")
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main(["--out", str(tmp_path / "out.json")])
    assert not (tmp_path / "out.json").exists()


def test_probe_modules_leave_jax_unloaded():
    code = ("import sys; import lightkrylov_tpu_torch.ops.probes; "
            "import lightkrylov_tpu_torch.probes.timing, lightkrylov_tpu_torch.probes.roofline, "
            "lightkrylov_tpu_torch.probes.manual_out, lightkrylov_tpu_torch.probes.deep_buffer, "
            "lightkrylov_tpu_torch.probes.stencil_sweep, lightkrylov_tpu_torch.probes.copy_shape; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('lightkrylov_tpu.') or m == 'lightkrylov_tpu' or m == 'bench']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# ---------------------------------------------------------------------------
# on the card


def counted(wrapper, *args):
    before = wrapper.LAUNCHES
    out = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.LAUNCHES == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("label,shape,block", COPY_CASES + [
    ("rows64", (8192, 8192), (64, 8192)), ("blk1024x256", (8192, 8192), (1024, 256)),
    ("wide", (4096, 16384), (128, 16384)), ("slim", (65536, 1024), (1024, 1024))],
    ids=[c[0] for c in COPY_CASES] + ["rows64", "blk1024x256", "wide", "slim"])
def test_cuda_copy_tiles_matches_plain(cuda, label, shape, block):
    x = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    assert torch.equal(counted(P.copy_tiles, x, block), P.copy_reference(x))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,depth,stage", [
    ((8192, 8192), 2, 12288), ((8192, 8192), 3, 24576), ((8192, 8192), 4, 49152),
    ((1000, 36), 3, 12288), ((64, 64), 2, 16), ((37, 4), 8, 1024)])
def test_cuda_copy_ring_matches_plain(cuda, shape, depth, stage):
    x = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    assert torch.equal(counted(P.copy_ring, x, depth, stage), P.copy_reference(x))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128), (24, 384), (4096, 4096), (65536, 1024)])
def test_cuda_reduce_8x128_matches_plain_and_repeats(cuda, shape):
    x = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    got = counted(P.reduce_8x128, x)
    want = P.reduce_8x128_reference(x.double())
    scale = P.reduce_8x128_reference(x.double().abs())
    assert bool(((got.double() - want).abs() <= 1e-5 * scale).all())
    assert torch.equal(counted(P.reduce_8x128, x), got)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_misaligned_input(cuda):
    x = torch.zeros(16 * 256 + 1, device=cuda)[1:].view(16, 256)
    for call in (lambda: P.copy_tiles(x, (8, 256)), lambda: P.copy_ring(x, 2, 1024),
                 lambda: P.reduce_8x128(x)):
        with pytest.raises(ValueError, match="16-byte"):
            call()
