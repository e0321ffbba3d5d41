"""BENCHMARK.json against its contract, and every name in it resolved to
its files: each cell to its configuration, traffic mix, family and load
generator, each metric to its reader."""

import json
import os
import re
import sys

import pytest

from conftest import BENCH, REPO

with open(os.path.join(REPO, "BENCHMARK.json")) as f:
    MANIFEST = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    w = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    entry = next(c for c in MANIFEST["configs"] if c["name"] == w["config"])
    assert w["traffic"] == cell
    with open(os.path.join(REPO, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH, "traffic", f"{cell}.json")) as f:
        traffic = json.load(f)
    assert os.path.isfile(os.path.join(BENCH, "families",
                                       f"{config['family']}.py"))
    assert os.path.isfile(os.path.join(BENCH, "loadgen",
                                       f"{traffic['generator']}.py"))
    assert config["reduced"] == entry["reduced"]
    assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_the_contract_asks(cell):
    def reported(group):
        return [m["name"] for m in MANIFEST[group]
                if "workloads" not in m or cell in m["workloads"]]
    end_to_end = reported("end_to_end")
    assert "setup_s" in end_to_end and len(end_to_end) >= 2
    assert reported("per_layer")


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] +
                         MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_metric_has_its_reader(metric):
    path = os.path.join(BENCH, "metrics", f"{metric['name']}.py")
    with open(path) as f:
        assert "def read(window)" in f.read()
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        end_to_end = {m["name"] for m in MANIFEST["end_to_end"]}
        assert metric["moves"] in end_to_end
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in MANIFEST[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_a_layer_keeps_one_spelling():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert layers <= {"api", "tensor_search", "core add path and inference",
                      "models", "kernels", "engine", "device"}


@pytest.mark.parametrize("cell", sorted(
    name[:-len(".json")] for name in os.listdir(os.path.join(BENCH, "traffic"))))
def test_every_traffic_file_resolves(cell):
    """A traffic file that BENCHMARK.json does not name yet resolves too,
    given its configuration's file, as the sweep and the tests run it."""
    sys.path.insert(0, BENCH)
    import run
    from tiny import CONFIG_FILES
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        manifest = run.with_cell(run.load_manifest(), cell, CONFIG_FILES[cell])
        entry, config, traffic = run.resolve(manifest, cell)
    finally:
        os.chdir(cwd)
    assert entry["chips"] == 1 and entry["traffic"] == cell
    assert traffic["warmup_rounds"] >= 2
    assert os.path.isfile(os.path.join(BENCH, "loadgen",
                                       f"{traffic['generator']}.py"))
    assert os.path.isfile(os.path.join(BENCH, "families",
                                       f"{config['family']}.py"))
