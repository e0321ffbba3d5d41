"""Nothing the harness loads is JAX or the JAX package: every module of the
benchmark imported in a fresh interpreter, then the top-level names in
``sys.modules`` (the part before the first dot, compared whole, since
``marqo_tpu_torch`` begins with ``marqo_tpu``)."""

import glob
import json
import os
import subprocess
import sys

from conftest import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "marqo_tpu"}


def test_no_module_of_the_harness_loads_jax():
    files = [f for f in glob.glob(os.path.join(BENCH, "**", "*.py"),
                                  recursive=True)
             if os.sep + "tests" + os.sep not in f]
    script = f"""
import importlib.util, json, os, sys
sys.path[:0] = [{REPO!r}, {BENCH!r}, {os.path.join(BENCH, "loadgen")!r}]
os.environ.update(USE_FLAX="0", USE_TF="0", USE_JAX="0")
import harness.server, harness.trace, harness.checks
import marqo_tpu_torch.api.app
for i, path in enumerate({files!r}):
    spec = importlib.util.spec_from_file_location(f"m{{i}}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "marqo_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_forbidden_names_compare_whole():
    sys.path.insert(0, BENCH)
    import run
    before = dict(sys.modules)
    try:
        sys.modules["marqo_tpu_torch_x"] = sys
        sys.modules["jaxlib.xla"] = sys
        assert run.forbidden_modules() == ["jaxlib"]
    finally:
        sys.modules.clear()
        sys.modules.update(before)
