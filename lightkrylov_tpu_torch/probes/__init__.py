"""Bandwidth probes of the card, through the kernels of ``csrc/probes.cu``.

The counterparts of the TPU probes in ``benchmarks/``, one module each, each
runnable on the card as ``python -m lightkrylov_tpu_torch.probes.<name>
[--out PATH]`` and printing one JSON line with ``"probe"`` and
``"device_kind"``:

- :mod:`.roofline`: copy (P1) and read-only (P2) rates, eager ``a + 1.0``,
  the stencils and the matmul rates;
- :mod:`.manual_out`: plain-store copy (P3) against an async double-buffered
  copy (P4);
- :mod:`.deep_buffer`: the async ring over depth and stage size (P5);
- :mod:`.stencil_sweep`: copy over the row-block size (P6) and the stencils
  at 8192^2;
- :mod:`.copy_shape`: copy over array and block shapes (P7).

:mod:`.timing` holds the differential timing loop and the datasheet rates.
A probe run without a CUDA device exits with an error; each module's
``run(device, ...)`` also takes the CPU, where the kernels' wrappers compute
their plain versions (for tests at tiny sizes; no CPU number is a rate of
the card).
"""
