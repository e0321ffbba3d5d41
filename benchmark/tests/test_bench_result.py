"""Whole runs of each cell at a tiny size on the CPU: the last line carries
exactly the contract's keys, the numbers compared close standard error,
and nothing the run loads is JAX or the JAX package."""

import json

import pytest

from tiny import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell,trace", [
    ("e5_base.bulk_ingest", 0), ("e5_base.bulk_ingest", 1),
    ("vit_l14.bulk_ingest", 0), ("e5_base.search", 0), ("e5_base.search", 1)])
def test_last_line_carries_the_contracts_keys(cell, trace, capsys):
    rc, line, err = run_cell(cell, 2147483700 + trace, capsys, trace=trace)
    assert rc == 0, err[-2000:]
    result = json.loads(line)
    expected = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == expected
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(result["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in result["metrics"]
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"}
    # the numbers compared close standard error, each with its limit
    tail = err.strip().splitlines()[-len(result["checks"]):]
    for line_, (name, check) in zip(tail, result["checks"].items()):
        assert line_.startswith(f"check {name}: ")
        assert set(check) == {"value", "limit"}


def test_the_run_loads_no_jax(capsys):
    import sys
    run_cell("e5_base.search", 2147483710, capsys)
    loaded = {name.split(".")[0] for name in sys.modules}
    assert not loaded & {"jax", "jaxlib", "flax", "marqo_tpu"}
    assert "marqo_tpu_torch" in loaded
