"""The port's launch path on the CPU: scripts/run_marqo_tpu_torch.sh held
against scripts/run_marqo_tpu.sh, its engine role, the API it starts (one
process, then two workers over an external engine), startup without a CUDA
device, and GET /device/cuda against the reference's response.

Every process started here runs in a session of its own
(``chip_smoke.Launched``, which the smoke's ``launch`` phase drives on the
card), each wait has a deadline, and the ``launched`` fixture kills every
process group in its teardown. Ports are free ones, never
tests/test_multiworker.py's 18850 and 18851."""

import json
import os
import re
import time
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from chip_smoke import (Launched, free_port, http_json, launch_env,
                        served_by)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SCRIPT = os.path.join("scripts", "run_marqo_tpu_torch.sh")
JAX_SCRIPT = os.path.join("scripts", "run_marqo_tpu.sh")

# the port's script differs from the JAX script, its package name aside, in
# these lines only, and why
SCRIPT_EDITS = {
    'exec python -m marqo_tpu_torch.engine.server --port "${ENGINE_PORT}"':
        "the engine role binds the MARQO_ENGINE_PORT it announces; the JAX "
        "script starts the shard without --port, so it binds 8080 whatever "
        "the variable says",
}

TINY = {"name": "tiny-launch", "type": "hf", "random_init": True,
        "pooling_method": "mean", "tokens": 32, "dimensions": 32,
        "architecture": {"vocab_size": 30522, "hidden_size": 32,
                         "num_layers": 2, "num_heads": 2,
                         "intermediate_size": 64}}
PRELOAD = json.dumps([{"model": TINY["name"], "modelProperties": TINY}])
DEADLINE_S = 120.0
CPU = {"MARQO_BEST_AVAILABLE_DEVICE": "cpu", "HF_HUB_OFFLINE": "1"}


@pytest.fixture
def launched(tmp_path):
    """Starts launch scripts in ``tmp_path``; kills what is left of each
    one's process group at teardown."""
    runs = []

    def start(args=(), script=PORT_SCRIPT, **variables):
        run = Launched(f"run{len(runs)}", list(args),
                       launch_env(str(tmp_path), **variables), str(tmp_path),
                       script=script)
        runs.append(run)
        return run

    yield start
    for run in runs:
        run.kill()


def _lines(rel):
    with open(os.path.join(REPO, rel)) as f:
        return f.read().splitlines()


def test_port_script_equals_the_jax_script_but_the_listed_lines():
    port = _lines(PORT_SCRIPT)
    reference = [re.sub(r"\bmarqo_tpu\b", "marqo_tpu_torch", line)
                 for line in _lines(JAX_SCRIPT)]
    assert len(port) == len(reference)
    edits = {p.strip(): r.strip() for p, r in zip(port, reference) if p != r}
    assert set(edits) == set(SCRIPT_EDITS)
    for edited, original in edits.items():
        assert edited.startswith(original + " "), (edited, original)
    assert os.access(os.path.join(REPO, PORT_SCRIPT), os.X_OK)


def test_jax_script_starts_its_engine_without_the_announced_port():
    """The reference finding behind SCRIPT_EDITS: the JAX script announces
    MARQO_ENGINE_PORT and starts the shard server, whose default is 8080,
    without it."""
    lines = [line.strip() for line in _lines(JAX_SCRIPT)]
    assert 'echo "Starting marqo-tpu engine shard on :${ENGINE_PORT}"' in \
        lines
    assert "exec python -m marqo_tpu.engine.server" in lines
    with open(os.path.join(REPO, "marqo_tpu", "engine", "server.py")) as f:
        assert 'parser.add_argument("--port", type=int, default=8080)' in \
            f.read()


def test_both_scripts_refuse_two_external_engines_alike(launched):
    outputs = []
    for script in (JAX_SCRIPT, PORT_SCRIPT):
        run = launched(script=script,
                       MARQO_ENGINE_QUERY_URL="http://127.0.0.1:1",
                       MARQO_ENGINE_CLUSTER='[["http://127.0.0.1:1"]]')
        assert run.proc.wait(timeout=DEADLINE_S) == 1
        outputs.append(run.log())
    assert outputs[0] == outputs[1]
    assert "both MARQO_ENGINE_QUERY_URL and MARQO_ENGINE_CLUSTER are set" \
        in outputs[0]


def test_script_serves_on_the_cpu_and_stops_on_sigterm(launched):
    port = free_port()
    run = launched(MARQO_HOST="127.0.0.1", MARQO_PORT=port,
                   MARQO_MODELS_TO_PRELOAD=PRELOAD, **CPU)
    run.wait_ready(port, "/health", DEADLINE_S)
    assert chip_smoke.warmup_buckets(run.log(), TINY["name"]) == [5]
    status, body = http_json(port, "POST", "/indexes/t1",
                             {"model": TINY["name"],
                              "modelProperties": TINY})
    assert status == 200, body
    status, body = http_json(port, "POST", "/indexes/t1/documents", {
        "documents": [{"_id": str(i), "text": "hello world " * (i + 1)}
                      for i in range(6)], "tensorFields": ["text"]})
    assert status == 200 and body["errors"] is False, body
    for method in ("TENSOR", "HYBRID", "LEXICAL"):
        status, body = http_json(port, "POST", "/indexes/t1/search",
                                 {"q": "hello", "searchMethod": method})
        assert status == 200 and len(body["hits"]) == 6, (method, body)
    # no CUDA device here: the route answers 400
    assert http_json(port, "GET", "/device/cuda")[0] == 400
    stopped = run.stop([port])
    assert stopped["pids"] == [run.proc.pid]


def test_script_without_cuda_and_without_the_variable_never_serves(tmp_path):
    """CUDA hidden (so this holds on a host with a card too) and
    MARQO_BEST_AVAILABLE_DEVICE unset: startup fails, nothing serves."""
    result = chip_smoke.launch_no_cuda(str(tmp_path))
    assert result["returncode"] not in (None, 0) and not result["served"]
    with open(os.path.join(tmp_path, "no-cuda.log")) as f:
        assert "No CUDA device is available to PyTorch" in f.read()


def test_engine_role_binds_marqo_engine_port(launched):
    port = free_port()
    run = launched(["engine"], MARQO_ENGINE_PORT=port)
    run.wait_ready(port, "/engine/health", DEADLINE_S)
    assert f"Starting marqo-tpu engine shard on :{port}" in run.log()
    status, body = http_json(port, "GET", "/engine/health")
    assert status == 200 and body["status"] == "green", body
    run.stop([port])


def test_two_workers_share_an_external_engine_and_settings(launched,
                                                           tmp_path):
    """Port of tests/test_multiworker.py through the script: the engine
    role, then two API workers over it. An index made on one worker takes
    documents and answers searches on the other; each request's worker is
    read from the process that holds the connection's server end."""
    from marqo_tpu_torch.core.index_management.settings_store import \
        IndexSettingsStore
    engine_port, api_port = free_port(), free_port()
    engine = launched(["engine"], MARQO_ENGINE_PORT=engine_port)
    engine.wait_ready(engine_port, "/engine/health", DEADLINE_S)
    api = launched(MARQO_HOST="127.0.0.1", MARQO_PORT=api_port,
                   MARQO_ENGINE_QUERY_URL=f"http://127.0.0.1:{engine_port}",
                   MARQO_API_WORKERS=2, MARQO_COORDINATION_BACKEND="file",
                   MARQO_COORDINATION_DIR=str(tmp_path / "coordination"),
                   MARQO_ENGINE_DATA_DIR=str(tmp_path / "data"),
                   # the engine's first search builds its HNSW graphs: on
                   # a loaded CPU host that can pass the default 1000 ms
                   MARQO_SEARCH_TIMEOUT_MS=30000,
                   MARQO_MODELS_TO_PRELOAD=PRELOAD, **CPU)
    api.wait_ready(api_port, "/health", DEADLINE_S)
    workers = api.pids()
    assert len(workers) == 2 and api.proc.pid in workers
    # one kept-alive connection on each worker
    connections = {}
    deadline = time.monotonic() + DEADLINE_S
    try:
        while len(connections) < 2:
            assert time.monotonic() < deadline, sorted(connections)
            conn, pid = served_by(api_port, workers)
            if pid is None or pid in connections:
                conn.close()
                time.sleep(0.05)
            else:
                connections[pid] = conn
        first, second = (connections[pid] for pid in workers)
        status, body = http_json(api_port, "POST", "/indexes/mw",
                                 {"model": TINY["name"],
                                  "modelProperties": TINY}, connection=first)
        assert status == 200, body
        time.sleep(IndexSettingsStore.RELOAD_INTERVAL_S + 0.5)
        status, body = http_json(api_port, "POST", "/indexes/mw/documents", {
            "documents": [{"_id": f"d{i}", "t": f"word {i}"}
                          for i in range(5)], "tensorFields": ["t"]},
            connection=second)
        assert status == 200 and body["errors"] is False, body
        for conn in (first, second):
            for method in ("LEXICAL", "TENSOR"):
                status, body = http_json(
                    api_port, "POST", "/indexes/mw/search",
                    {"q": "word", "searchMethod": method, "limit": 10},
                    connection=conn)
                assert status == 200 and len(body["hits"]) == 5, body
    finally:
        for conn in connections.values():
            conn.close()
    assert chip_smoke.warmup_buckets(api.log(), TINY["name"]) == [5, 5]
    # a small corpus: the engine process never loaded PyTorch
    assert not chip_smoke.loads_torch(engine.proc.pid)
    api.stop([api_port])
    engine.stop([engine_port])


def test_workers_require_an_external_engine(monkeypatch):
    from marqo_tpu_torch.api.app import main
    from marqo_tpu_torch.api.exceptions import StartupSanitationError
    monkeypatch.delenv("MARQO_ENGINE_QUERY_URL", raising=False)
    monkeypatch.delenv("MARQO_ENGINE_CLUSTER", raising=False)
    with pytest.raises(StartupSanitationError, match="external engine"):
        main(host="127.0.0.1", port=free_port(), workers=2)


# --- GET /device/cuda ---------------------------------------------------------

H100 = "NVIDIA H100 80GB HBM3"


def _get(app, path):
    response = app.dispatch("GET", path, b"", {})
    return response.status, response.body


@pytest.fixture(scope="module")
def port_app():
    from marqo_tpu_torch.api.app import build_app, generate_config
    return build_app(generate_config())


@pytest.fixture(scope="module")
def reference_app():
    from marqo_tpu.api.app import build_app, generate_config
    return build_app(generate_config())


@pytest.fixture
def one_card(monkeypatch):
    """torch.cuda as one H100 with 3 GiB allocated shows it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: H100)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i=0: SimpleNamespace(total_memory=80 * 2 ** 30))
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda i=0: 3 * 2 ** 30)


def test_device_cuda_has_the_reference_keys(port_app, reference_app,
                                            one_card, monkeypatch):
    import jax
    monkeypatch.setattr(jax, "devices", lambda: [SimpleNamespace(
        platform="tpu", id=0, device_kind="TPU v5 lite")])
    status, reference = _get(reference_app, "/device/cuda")
    assert status == 200
    status, port = _get(port_app, "/device/cuda")
    assert status == 200
    assert set(port) == set(reference) == {"cuda_devices"}
    assert [set(d) for d in port["cuda_devices"]] == \
        [set(d) for d in reference["cuda_devices"]]
    # the deliberate difference: the port fills the memory fields, which
    # the reference leaves None
    device = port["cuda_devices"][0]
    assert device == {"device_id": 0, "device_name": H100,
                      "memory_used": "3.0 GiB", "total_memory": "80.0 GiB",
                      "utilization": None}
    assert reference["cuda_devices"][0]["memory_used"] is None
    assert reference["cuda_devices"][0]["total_memory"] is None


@pytest.mark.parametrize("package", ["reference", "port"])
def test_device_cuda_without_an_accelerator_is_400(package, port_app,
                                                   reference_app,
                                                   monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    app = reference_app if package == "reference" else port_app
    status, body = _get(app, "/device/cuda")
    assert status == 400, body
    assert "No accelerator" in body["message"]
