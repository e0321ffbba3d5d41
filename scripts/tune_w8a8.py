#!/usr/bin/env python3
"""Time kernel B3 (marqo_tpu_torch's W8A8 linear layer) on a CUDA card at
the int8 e5-base encoder's shapes, bf16: the whole call with CUDA events,
its row quantizer and GEMM apart (torch.profiler), and the host time a
call takes to enqueue (the whole wrapper, and its C entry point alone).
Prints one JSON line per shape and a last line with the card's name and
power limit.

    python3 scripts/tune_w8a8.py [--root CHECKOUT]

``--root`` imports marqo_tpu_torch from another checkout (an older commit
unpacked beside this one), so two versions can be timed in one run of the
card. Needs a CUDA device; exits non-zero without one.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (M, K, N): the padded ingest batch (256 x 128 tokens) through q, k, v
# packed, attn_out, ffn_in, ffn_out; a batch-1 query (32 tokens)
SHAPES = ((32768, 768, 768), (32768, 768, 2304), (32768, 768, 3072),
          (32768, 3072, 768), (32, 768, 2304), (32, 768, 3072))


def _chip_smoke():
    """This checkout's chip_smoke.py, for its inputs, bounds and timers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def host_us(torch, fn) -> float:
    """Host microseconds to enqueue one call of ``fn``: the least of 15
    runs of 100 calls, as the host is shared."""
    runs = []
    for _ in range(15):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(100):
            fn()
        runs.append((time.perf_counter() - start) / 100 * 1e6)
    torch.cuda.synchronize()
    return min(runs)


def c_entry(torch, build, x, w_q, w_scale, bias):
    """A call of the library's C entry point on output and scratch buffers
    allocated once."""
    M, K = x.shape
    N = w_q.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    x_q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    x_scale = torch.empty((M,), dtype=torch.float32, device=x.device)
    entry = build.load_library().marqo_w8a8_matmul
    args = (*(t.data_ptr() for t in (x, w_q, w_scale, bias, out, x_q,
                                     x_scale)),
            M, K, N, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    return lambda: entry(*args)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tune_w8a8: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from marqo_tpu_torch.ops import _build
    from marqo_tpu_torch.ops import quant_matmul as qm
    smoke = _chip_smoke()
    start = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - start
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for M, K, N in SHAPES:
        x, w_q, w_scale, bias = smoke.w8a8_inputs(M, K, N, torch.bfloat16,
                                                  seed=M)
        iters = 20 if M > 32 else 200

        def call():
            qm.w8a8_matmul(x, w_q, w_scale, bias)

        row = {"shape": [M, K, N], "root": os.path.abspath(args.root),
               **smoke.w8a8_bound(M, K, N),
               "ms_runs": [smoke.cuda_ms(call, iters) for _ in range(2)],
               # names that match an older checkout's kernels too
               "split_ms": smoke.kernel_times_ms(
                   call, iters, ("quantize_rows", "w8a8_gemm"))}
        # host time to enqueue a call, whole (checks, allocations, the C
        # entry) and the C entry alone on buffers allocated once (the TMA
        # descriptors and two launches)
        row["host_us_per_call"] = host_us(torch, call)
        row["host_us_c_entry"] = host_us(torch, c_entry(torch, _build, x,
                                                        w_q, w_scale, bias))
        print(json.dumps(row), flush=True)
    print(json.dumps({"build_s": build_s, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
