#!/usr/bin/env python3
"""Time the two bf16 tile loops of the attention kernels against each other
and against SDPA, on one Hopper card: B2 (ops/fused_attention.py) with no
mask and B1 (ops/flash_attention.py) in padding mode, over token counts
either side of ``tile_loop``'s rule and at the shapes the served towers
and encoders give the kernels.

    python3 scripts/tune_attention.py [--quick]

Each shape: the mma.sync loop, the wgmma loop, the wgmma loop, the mma.sync
loop (``queued_ms``: the calls queued behind a device-side sleep, 20 a
run), then SDPA once, all on the projections' layout. One JSON line a
shape, the card's name and power limit first. ``--quick`` times only the
token counts around the rule.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (B, N, S, D): the rule's edge at the video tower's temporal batch and at
# a tower's, then the served shapes (PERF.md section 6)
EDGE = [(257, 16, S, 64) for S in (1, 8, 16, 24, 32, 48, 64)] + [
    (16, 12, S, D) for S in (8, 16, 24, 32, 64) for D in (32, 64, 128)] + [
    (16, 12, S, 80) for S in (16, 32, 64, 65)]
SERVED = [(16, 12, 50, 64), (16, 12, 64, 64), (16, 12, 196, 64),
          (1, 6, 197, 64), (8, 16, 257, 64), (16, 16, 257, 64),
          (16, 16, 497, 64), (16, 16, 577, 64), (10, 12, 577, 64),
          (8, 16, 729, 72), (16, 16, 729, 72), (4, 16, 730, 80),
          (4, 16, 730, 104), (514, 16, 8, 64)]
B1_SHAPES = [(256, 12, S, 64) for S in (16, 32, 64, 128)] + [
    (32, 8, 128, D) for D in (32, 48, 72, 80)] + [(16, 6, 128, 64),
                                                (8, 6, 128, 64)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true")
    args = parser.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("tune_attention: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from marqo_tpu_torch.ops import flash_attention as fa
    from marqo_tpu_torch.ops import fused_attention as fused
    print(cs.nvidia_smi_line(), flush=True)

    def paired(run):
        times = {"mma_sync": [], "wgmma": []}
        for loop in ("mma_sync", "wgmma", "wgmma", "mma_sync"):
            times[loop].append(cs.queued_ms(lambda: run(loop), 20))
        return {loop: sum(t) / 2 for loop, t in times.items()} | {
            f"{loop}_runs": t for loop, t in times.items()}

    shapes = EDGE if args.quick else EDGE + SERVED
    for B, N, S, D in shapes:
        q, k, v, _, _ = cs.attention_inputs(B, N, S, D, torch.bfloat16,
                                            seed=S)
        q, k, v = cs.projection_views(q, k, v, "projection")
        row = paired(lambda loop: fused._launch(q, k, v, None, loop=loop))
        sdpa = cs.queued_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                            20)
        print(json.dumps({"kernel": "fused_attention", "mode": "nomask",
                          "shape": [B, N, S, D], "rule": fa.tile_loop(
                              S, D, torch.bfloat16), **row, "sdpa": sdpa}),
              flush=True)
    for B, N, S, D in ([] if args.quick else B1_SHAPES):
        q, k, v, pad, _ = cs.attention_inputs(B, N, S, D, torch.bfloat16,
                                              seed=S)
        q, k, v = cs.projection_views(q, k, v, "projection")
        row = paired(lambda loop: fa._launch(q, k, v, pad, "padding",
                                             loop=loop))
        sdpa = cs.queued_ms(cs._sdpa(torch, q, k, v,
                                     (pad > 0)[:, None, None, :]), 20)
        print(json.dumps({"kernel": "masked_attention", "mode": "padding",
                          "shape": [B, N, S, D], "rule": fa.tile_loop(
                              S, D, torch.bfloat16), **row, "sdpa": sdpa}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
