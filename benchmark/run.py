#!/usr/bin/env python3
"""One run of one cell of the benchmark of marqo_tpu_torch.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout. The cell, its configuration and its
traffic mix are found by name: ``BENCHMARK.json`` names the cell and its
configuration's file; the mix is ``benchmark/traffic/<cell>.json``; the
configuration's family is ``benchmark/families/<family>.py``; the load
generator is ``benchmark/loadgen/<generator>.py``; each metric is
``benchmark/metrics/<metric>.py``. A new cell, mix or metric is new files
and entries in BENCHMARK.json.

In this process: the port's HTTP app on a localhost port, the checkpoint
made from the seed and handed to it by ``modelProperties.localpath``, the
index and its base corpus, then the load generator in a child process,
which warms the cell's shapes, measures for ``--seconds`` and reports.
After the window the timed path's output is held against the plain
reference (harness/checks.py). The last line of standard output is the
result; the numbers compared, each with its limit, are the last lines of
standard error and the result's last key.

``--control`` (never passed by the benchmark's own runs) puts the cell's
control in the program's place: the configuration a step below its
precision, which the comparison has to fail (tests/test_bench_control.py).
"""

import os
import time


def _process_start() -> float:
    """This process's start on the wall clock, from /proc where there is one."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


PROCESS_START = _process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
# the harness's packages, then the program at the checkout's root
for _path in (os.path.dirname(BENCH), BENCH):
    if _path not in sys.path:
        sys.path.insert(0, _path)

# top-level module names that may not be loaded when the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "marqo_tpu")
INDEX = "bench"
LAST = None  # the last run's Window, for benchmark/sweep.py


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve(manifest: dict, workload: str) -> tuple:
    """(cell, configuration, traffic) of ``workload``."""
    cell = next((w for w in manifest["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    with open(entry["file"]) as f:
        config = json.load(f)
    with open(os.path.join(BENCH, "traffic", f"{workload}.json")) as f:
        traffic = json.load(f)
    return cell, config, traffic


def metric_names(manifest: dict, workload: str, trace: bool) -> list:
    group = manifest["per_layer"] if trace else manifest["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def graph_keys() -> dict:
    """{key: capture seconds} of every loaded model's CUDA graphs."""
    from marqo_tpu_torch.inference import vectorise
    out = {}
    for entry in list(vectorise._available_models.values()):
        graphs = getattr(entry["model"], "graphs", None)
        if graphs is not None:
            out.update((key, g.seconds) for key, g in graphs.graphs.items())
    return out


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def base_corpus(traffic: dict, config: dict, server, checkout: str,
                device, log) -> None:
    """Fills the index's base corpus: fed through the engine, or, with
    ``hnsw``, restored from the checkout's snapshot of it where a run has
    written one (as a restart restores an engine), else fed, linked and
    snapshotted, since linking takes minutes and restoring seconds (a
    restore re-feeds the documents, so without a graph it saves nothing);
    then the exact scan's device comes up over every field of 50,000 rows
    or more."""
    spec = traffic.get("base_corpus")
    if spec is None:
        return
    from marqo_tpu_torch.engine.torch_scorer import bring_up_engine
    engine, name = server.config.engine, server.engine_name(INDEX)
    snapshot = os.path.join(
        checkout, "build", "benchmark_corpus",
        f"{config['family']}-{spec['corpus_seed']}-{spec['docs']}-hnsw")
    if spec["hnsw"] and os.path.isdir(snapshot):
        engine.delete_index(name)
        engine.restore(snapshot)
        log("base corpus restored")
    else:
        make_base_corpus(spec, config, device).feed(
            engine, name, traffic["tensor_fields"])
        log("base corpus fed")
    if spec["hnsw"] and not os.path.isdir(snapshot):
        for shard in engine._shards(name):
            with shard.lock:
                for field in shard.tensors.values():
                    field._ensure_hnsw()
        log("base corpus linked (HNSW)")
        partial = snapshot + ".partial"
        shutil.rmtree(partial, ignore_errors=True)
        engine.snapshot(partial)
        os.replace(partial, snapshot)
        log("base corpus snapshotted")
    bring_up_engine(engine)
    log("exact scan brought up")


def make_base_corpus(spec: dict, config: dict, device):
    from harness.base_corpus import BaseCorpus
    from reference import corpus
    words = corpus.words(spec["corpus_seed"], spec["vocabulary_words"])
    return BaseCorpus(spec["corpus_seed"], words, spec,
                      config["marqo"]["model_properties"]["dimensions"], device)


def start_generator(traffic: dict, spec: dict, workdir: str):
    path = os.path.join(workdir, "loadgen.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    child = subprocess.Popen(
        [sys.executable, os.path.join(BENCH, "loadgen",
                                      f"{traffic['generator']}.py"), path],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        expect(child, "READY")
    except RuntimeError:
        child.kill()
        child.wait()
        raise
    return child


def tell(child, word: str) -> None:
    child.stdin.write(word + "\n")
    child.stdin.flush()


def expect(child, word: str) -> None:
    line = child.stdout.readline().strip()
    if line != word:
        raise RuntimeError(f"load generator: {line!r} where {word} was due")


def warm_up(child, traffic: dict, log) -> None:
    """More rounds of the generator's warm-up, up to ``warmup_rounds`` in
    all, until one captures no new graph: the window's mix then finds its
    graphs already captured, save for a rare key (set-up's and the
    window's captures are printed after it)."""
    keys = len(graph_keys())
    for done in range(2, traffic["warmup_rounds"] + 1):
        tell(child, "WARM")
        expect(child, "READY")
        now = len(graph_keys())
        log(f"warm-up round {done}, {now - keys} new graph(s)")
        if now == keys:
            return
        keys = now


def merge(base: dict, changes: dict) -> dict:
    """``base`` with ``changes`` written over it, nested dicts merged."""
    out = dict(base)
    for key, value in changes.items():
        out[key] = merge(out[key], value) if isinstance(value, dict) and \
            isinstance(out.get(key), dict) else value
    return out


def load_manifest() -> dict:
    with open("BENCHMARK.json") as f:
        return json.load(f)


def with_cell(manifest: dict, workload: str, config_file: str) -> dict:
    """``manifest`` and a one-chip cell ``workload`` of its traffic file and
    the configuration in ``config_file``, where BENCHMARK.json holds no
    such cell (the sweep of a cell not yet in it, the tests)."""
    if any(w["name"] == workload for w in manifest["workloads"]):
        return manifest
    config = os.path.splitext(os.path.basename(config_file))[0]
    out = dict(manifest, workloads=manifest["workloads"] + [
        {"name": workload, "config": config, "traffic": workload,
         "chips": 1}])
    if all(c["name"] != config for c in manifest["configs"]):
        out["configs"] = manifest["configs"] + [
            {"name": config, "file": config_file, "reduced": []}]
    return out


def run(args, device: str = "cuda", chips_check: bool = True,
        overrides: dict = None, manifest: dict = None) -> int:
    """One run; the tests pass ``device="cpu"``, no chip check and tiny
    ``overrides`` of the configuration and the traffic; the sweep and the
    tests may pass a manifest with a cell added that BENCHMARK.json does
    not hold."""
    import torch
    manifest = manifest or load_manifest()
    cell, config, traffic = resolve(manifest, args.workload)
    overrides = overrides or {}
    config = merge(config, overrides.get("config", {}))
    traffic = merge(traffic, overrides.get("traffic", {}))
    if chips_check and (not torch.cuda.is_available() or
                        torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    checkout = os.getcwd()
    workdir = tempfile.mkdtemp(prefix="benchmark-")
    try:
        return _run(args, manifest, cell, config, traffic, checkout, workdir,
                    device)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(args, manifest, cell, config, traffic, checkout, workdir,
         device) -> int:
    import torch
    from harness import checks
    from harness.server import Server, environment
    from harness.trace import Profiler
    from harness.window import Window
    from reference.precision import float32_only

    def log(step: str) -> None:
        print(f"set-up: {step} at {time.time() - PROCESS_START:.3f} s",
              file=sys.stderr, flush=True)

    log("harness loaded")
    environment(checkout, workdir, config["marqo"].get("env", {}))
    family = load_module(os.path.join(BENCH, "families",
                                      f"{config['family']}.py"),
                         f"family_{config['family']}")
    checkpoint = os.path.join(workdir, "checkpoint")
    words = family.write_checkpoint(config, args.seed, checkpoint, device)
    log("checkpoint written")
    server = Server()
    log("server up")
    # the control: the program's own lower precision, or the reference's
    program_control = args.control and family.CONTROL == "program"
    reference_control = args.control and family.CONTROL == "reference_fp8"
    child = None
    try:
        server.call("POST", f"/indexes/{INDEX}", family.index_settings(
            config, args.seed, checkpoint, program_control))
        log("index created")
        base_corpus(traffic, config, server, checkout, device, log)
        child = start_generator(traffic, {
            "port": server.port, "index": INDEX, "seed": args.seed,
            "seconds": args.seconds, "traffic": traffic,
            "vocabulary_words": config["assumed"]["vocabulary_words"],
            "telemetry": bool(args.trace)}, workdir)
        log("load generator's first warm-up round done")
        warm_up(child, traffic, log)
        # every window starts from the same collector state: set-up's
        # objects (the base corpus) collected and counted once, so that
        # how many full collections land in the window does not depend on
        # where set-up left the collector's counters
        gc.collect()
        log("garbage collected")
        keys_before = graph_keys()
        profiler = Profiler() if args.trace else None
        if profiler:
            profiler.start()
        tell(child, "GO")
        expect(child, "START")
        window_start = time.time()
        line = child.stdout.readline().strip()
        trace = profiler.stop() if profiler else None
        if line != "END":
            raise RuntimeError(f"load generator: {line!r} where END was due")
        results = json.loads(child.stdout.readline())
        child.wait(timeout=120)
        child = None
        memory_peak = torch.cuda.max_memory_allocated() \
            if device == "cuda" else 0
        keys_after = graph_keys()
        new = {k: s for k, s in keys_after.items() if k not in keys_before}
        print(f"graphs: {len(keys_before)} keys captured in set-up "
              f"({sum(keys_before.values()):.3f} s), {len(new)} in the "
              f"window ({sum(new.values()):.3f} s): "
              f"{[k[0] + str(k[3]) for k in new]}", file=sys.stderr)
        found = forbidden_modules()
        if found:
            print(f"modules loaded that the port may not load: {found}",
                  file=sys.stderr)
            return 4
        window = Window(cell, config, traffic, args.seed, args.seconds,
                        results, words, family, checkpoint, device)
        print(f"window by fifths: {window.fifths()}", file=sys.stderr)
        window.trace = trace
        window.setup_s = window_start - PROCESS_START
        window.power_limit_w = power_limit() if device == "cuda" else "none"
        float32_only()
        if traffic["generator"] == "open_search":
            base = make_base_corpus(traffic["base_corpus"], config, device)
            attempted, failed, compared = checks.search(window, base)
        else:
            attempted, failed, compared = checks.ingest(window, server, INDEX,
                                                        reference_control)
    finally:
        if child is not None:
            child.kill()
            child.wait()
        server.close()
    metrics = {}
    for m in metric_names(manifest, args.workload, bool(args.trace)):
        reader = load_module(os.path.join(BENCH, "metrics", f"{m['name']}.py"),
                             f"metric_{m['name']}")
        value = reader.read(window)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(0)
                   if device == "cuda" else device,
                   "count": cell["chips"], "memory_peak_bytes": memory_peak}
    result = {"correct": all(value <= limit for _, value, limit in compared),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_info}
    if trace is not None:
        device_info.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {
            "device_ops": sorted(trace.seconds_by_name().items(),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": trace.idle_gaps(10)}
    print(f"card: {window.power_limit_w}", file=sys.stderr)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in compared}
    for name, value, limit in compared:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(result))
    global LAST
    LAST = window
    return 0


def parse(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", action="store_true",
                        help=argparse.SUPPRESS)
    return parser.parse_args(argv)


if __name__ == "__main__":
    sys.exit(run(parse()))
