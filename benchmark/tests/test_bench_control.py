"""The control of every cell, on the card at the cell's own size: the
configuration a step below its precision in the program's place (e5: the
program's own int8 path, kernel B3) has to come out not correct on three
seeds. The benchmark's own runs never run
it. Run on an H100 from the repository's root:

    python -m pytest benchmark/tests/test_bench_control.py -q
"""

import json
import subprocess
import sys

import pytest

from conftest import REPO

CELLS = ("e5_base.bulk_ingest",)
SEEDS = (2147484001, 2147484002, 2147484003)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA H100")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell, seed):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "10", "--trace", "0", "--control"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    print(cell, seed, json.dumps(result["checks"]))
    assert result["correct"] is False, result["checks"]
