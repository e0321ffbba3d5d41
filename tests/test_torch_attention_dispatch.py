"""The attention kernels' choice of tile loop, on the CPU:
ops/flash_attention.py ``tile_loop`` as a pure function (fp32 on the exact
FMA loop at every shape; bf16 on the wgmma loop of
csrc/attention_tile_sm90.cuh at the served towers' token counts, and on
the mma.sync loop exactly where PERF.md section 6 records it faster on
an H100: S <= 32 at D <= 32, S <= 16 at D <= 64, S <= 64 at D <= 128),
the loops each dtype may run, and the CPU route, which takes the plain
twins and counts no launch on any loop. The kernels themselves run only on
the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from marqo_tpu_torch.ops import flash_attention as fa
from marqo_tpu_torch.ops import fused_attention as fused

SEQ_LENS = (1, 7, 8, 16, 17, 32, 33, 63, 64, 65, 128, 197, 257, 497, 577,
            729, 4096)


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_fp32_takes_the_fma_loop_at_every_shape(D):
    for S in SEQ_LENS:
        assert fa.tile_loop(S, D, torch.float32) == "fma"


# (B, N, S, D) where the towers and encoders serve B1 and B2 in bf16
# (PERF.md section 6): the long-token towers and the e5 encoder
WGMMA_SHAPES = [
    (16, 16, 577, 64),   # EVA02-L-14-336
    (16, 16, 497, 64),   # LanguageBind audio
    (10, 12, 577, 64),   # OWL-ViT B/32, 10 hits
    (16, 16, 257, 64),   # ViT-L/14: CLIP, CoCa, LanguageBind image
    (8, 16, 257, 64),    # ViT-L/14 dp group; the video tower's spatial
    (16, 16, 729, 72),   # SO400M/14 @384
    (16, 12, 196, 64),   # SigLIP B-16 image
    (1, 6, 197, 64),     # DINO ViT-S/16
    (16, 12, 64, 64),    # SigLIP B-16 text
    (16, 12, 50, 64),    # CoCa B-32 image
    (256, 12, 128, 64),  # e5-base padded and packed (B1, B2 "flash")
    (16, 6, 128, 64),    # the e5 tp shard
    (32, 8, 128, 48), (32, 8, 128, 72), (32, 8, 128, 80),  # C1's head dims
    (4, 16, 730, 104),   # ViT-bigG-14's head dim at 730 tokens
]


@pytest.mark.parametrize("B,N,S,D", WGMMA_SHAPES)
def test_bf16_served_shapes_take_the_wgmma_loop(B, N, S, D):
    assert fa.tile_loop(S, D, torch.bfloat16) == "wgmma"


# (S, D, loop) either side of each head-dim class's edge, as measured
# (scripts/tune_attention.py; PERF.md section 6)
EDGES = [
    (8, 64, "mma_sync"),    # the video tower's temporal attention
    (16, 64, "mma_sync"), (17, 64, "wgmma"), (24, 64, "wgmma"),
    (16, 48, "mma_sync"), (17, 48, "wgmma"),
    (8, 32, "mma_sync"), (24, 32, "mma_sync"), (32, 32, "mma_sync"),
    (33, 32, "wgmma"), (64, 32, "wgmma"), (32, 8, "mma_sync"),
    (33, 8, "wgmma"),
    (16, 128, "mma_sync"), (64, 128, "mma_sync"), (65, 128, "wgmma"),
    (64, 72, "mma_sync"), (65, 72, "wgmma"), (1, 128, "mma_sync"),
]


@pytest.mark.parametrize("S,D,loop", EDGES)
def test_bf16_keeps_mma_sync_only_where_the_card_showed_it_faster(S, D,
                                                                  loop):
    assert fa.tile_loop(S, D, torch.bfloat16) == loop


def test_the_rule_covers_every_head_dim_and_grows_with_it():
    """Every head dim falls in a class of MMA_SYNC_SEQ_LEN, and each
    class's edge is a token count the wgmma loop serves just past."""
    for D in fa.HEAD_DIMS:
        limit = next(s for d, s in fa.MMA_SYNC_SEQ_LEN if D <= d)
        assert fa.tile_loop(limit, D, torch.bfloat16) == "mma_sync"
        assert fa.tile_loop(limit + 1, D, torch.bfloat16) == "wgmma"
    assert fa.MMA_SYNC_SEQ_LEN[-1][0] == max(fa.HEAD_DIMS)


@pytest.mark.parametrize("dtype,loop,ok", [
    (torch.float32, "fma", True), (torch.float32, "wgmma", False),
    (torch.float32, "mma_sync", False), (torch.bfloat16, "wgmma", True),
    (torch.bfloat16, "mma_sync", True), (torch.bfloat16, "fma", False),
    (torch.float16, "wgmma", False)])
def test_each_dtype_runs_only_its_loops(dtype, loop, ok):
    if ok:
        fa.check_loop("attention", loop, dtype)
    else:
        with pytest.raises(ValueError, match="tile loop"):
            fa.check_loop("attention", loop, dtype)


def test_every_loop_has_a_code_and_a_counter():
    loops = {loop for loops in fa.DTYPE_LOOPS.values() for loop in loops}
    assert loops == set(fa.LOOP_CODES) == set(fa.LOOP_LAUNCHES) == set(
        fused.LOOP_LAUNCHES)
    assert sorted(fa.LOOP_CODES.values()) == [0, 1, 2]


def _inputs(S, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, 3, S, D)).astype(np.float32)).to(dtype) for _ in range(3))
    mask = (np.arange(S)[None] < np.array([[S], [S // 2 + 1]])).astype(
        np.int32)
    return q, k, v, torch.from_numpy(mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,D", [(8, 64), (65, 32), (257, 64)])
def test_cpu_route_takes_the_twins_and_counts_no_loop(S, D, dtype):
    """On the CPU every entry point returns its twin's output and no
    counter moves, whichever loop the card would run."""
    q, k, v, mask = _inputs(S, D, dtype)
    counters = (fa.LAUNCHES, fa.LOOP_LAUNCHES, fused.LAUNCHES,
                fused.LOOP_LAUNCHES)
    before = [dict(c) for c in counters]
    assert torch.equal(fa.attention_padding(q, k, v, mask),
                       fa.attention_padding_reference(q, k, v, mask))
    assert torch.equal(fa.attention_segment(q, k, v, mask),
                       fa.attention_segment_reference(q, k, v, mask))
    for kw in ({}, {"pad_mask": mask}, {"segment_ids": mask}):
        assert torch.equal(fused.fused_attention(q, k, v, **kw),
                           fused.fused_attention_reference(q, k, v, **kw))
    assert [dict(c) for c in counters] == before


@pytest.mark.parametrize("loop", [None, "wgmma", "mma_sync"])
def test_launch_off_the_card_raises_whatever_the_loop(loop):
    """The kernels' launch refuses a tensor that is not on a CUDA device
    before it looks at the loop: there is no fallback to the twin."""
    q = torch.empty(2, 2, 16, 8, dtype=torch.bfloat16, device="meta")
    mask = torch.empty(2, 16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa._launch(q, q, q, mask, "padding", loop=loop)
    with pytest.raises(ValueError, match="unsupported device"):
        fused._launch(q, q, q, None, loop=loop)
