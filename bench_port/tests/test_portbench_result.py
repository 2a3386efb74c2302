"""Whole runs of each cell on the CPU at a tiny size: the result line's
keys, a traced run's breakdown, the compared numbers with their limits."""

import json

import pytest

from bench_port import session

CELLS = ["poisson3162.gmres30", "poisson3162f64.cg", "poisson6324x4.gmres30"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(bench, cell, trace, seconds=0.3, patch=None):
    line, checks = session.run_cell(cell, 2**33 + 5, seconds, trace, device="cpu", bench=bench,
                                    patch=patch)
    return json.loads(line), checks


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_line_has_the_contract_keys_and_the_end_to_end_metrics(bench, cell):
    out, checks = run(bench, cell, False)
    assert list(out)[:5] == KEYS and "breakdown" not in out and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    e2e = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == e2e and "setup_s" in e2e
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["device"]["count"] == (4 if "x4" in cell else 1)
    for name, c in out["checks"].items():
        assert f"check {name}: {c['value']!r} (limit {c['limit']!r})" in checks


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line_has_a_breakdown_and_the_per_layer_metrics(bench, cell):
    out, _ = run(bench, cell, True)
    assert list(out)[:5] == KEYS and "breakdown" in out
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in out["breakdown"].values())
    assert {"busy_s", "window_s"} <= set(out["device"]) and out["device"]["window_s"] > 0
    per_layer = {m["name"] for m in bench["per_layer"] if cell in m.get("workloads", [cell])}
    # the readers that need the card (timed operators) find nothing on the CPU
    assert set(out["metrics"]) <= per_layer
    assert "host_reads_per_cycle" in out["metrics"] or "host_reads_per_solve" in out["metrics"]


def test_gmres_counts_33_host_reads_a_cycle_and_66_collectives_on_four_ranks(bench):
    one, _ = run(bench, "poisson3162.gmres30", True)
    four, _ = run(bench, "poisson6324x4.gmres30", True)
    assert one["metrics"]["host_reads_per_cycle"]["value"] == 33
    assert four["metrics"]["collectives_per_cycle"]["value"] == 66
