"""marqo_tpu_torch's CUDA kernels against their plain twins, on the card:
B1 (ops/flash_attention.py, masked attention), B2 (ops/fused_attention.py,
flash attention with no mask or segment ids) and B3 (ops/quant_matmul.py,
the fused W8A8 linear layer). The attention kernels are also fed the
encoders' own layouts (views of the projection outputs), ragged token
counts and head dims, and masks that exercise each tile-skipping rule of
csrc/attention_tile.cuh, on the tile loop ``tile_loop`` picks and, in
bf16, on both tile loops forced (the wgmma loop of
csrc/attention_tile_sm90.cuh at every head dim and across its 64- and
128-row tile edges); the built library's bf16 attention instances must
hold tensor-core instructions (HMMA in the mma.sync loop, HGMMA in the
wgmma loop), and B3's GEMM instances the warpgroup MMA (IGMMA) and no
mma.sync (IMMA).
Skips without an sm_90 CUDA device and nvcc; on a Hopper host run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the port's host
need not have). Tolerances as chip_smoke.py's kernel phases: attention
``chip_smoke.check_attention`` (fp32 |err| <= 1e-5; bf16 |err| <= 4e-3 +
1e-2 |ref|, and a softmax scale off by 10% must fail that bound); B3 as its
quant_kernel phase: equal to its twin bit for bit (torch.equal), fp32 and
bf16.
"""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import (PROJECTION_LAYOUTS, SCALE_CONTROL, attention_inputs,
                        check_attention, is_projection_layout,
                        projection_views, w8a8_inputs)
from marqo_tpu_torch.ops import _build
from marqo_tpu_torch.ops import flash_attention as fa
from marqo_tpu_torch.ops import fused_attention as fused
from marqo_tpu_torch.ops import quant_matmul as qm

pytestmark = pytest.mark.cuda



def _control(plain, q, k, v, *mask, **masks):
    """The twin with the softmax scale off by SCALE_CONTROL, which the bf16
    tolerance must refuse; None in fp32 and where every row attends to one
    key (S = 1), which no scale changes."""
    if q.dtype != torch.bfloat16 or q.shape[2] == 1:
        return None
    return plain(q * SCALE_CONTROL, k, v, *mask, **masks)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernel is built for sm_90a (Hopper)")
    try:
        _build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernel")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 16, 32, 48, 64, 72, 80, 128])
@pytest.mark.parametrize("S", [1, 16, 32, 100, 128, 512])
def test_kernel_matches_twin(card, S, D, dtype):
    """Every padded instance of B1, and the head dims 48, 72 and 80 that
    it took only after ROADMAP C1."""
    q, k, v, pad, seg = attention_inputs(4, 3, S, D, dtype, seed=S * D)
    for mode, mask, kernel, plain in (
            ("padding", pad, fa.attention_padding,
             fa.attention_padding_reference),
            ("segment", seg, fa.attention_segment,
             fa.attention_segment_reference)):
        before = fa.LAUNCHES[mode]
        out = kernel(q, k, v, mask)
        torch.cuda.synchronize()
        assert fa.LAUNCHES[mode] == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        assert torch.isfinite(out).all()
        check_attention(out, plain(q, k, v, mask),
                        _control(plain, q, k, v, mask), mode)


def test_kernel_refuses_non_contiguous_input(card):
    q, k, v, pad, _ = attention_inputs(4, 3, 16, 64, torch.float32, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        fa.attention_padding(q.transpose(2, 3).contiguous().transpose(2, 3),
                             k, v, pad)


# chip_smoke.py's B2 checks (the ViT towers' (tokens, head dim), with the
# ragged last key tile at S = 50, 257, 577 and 730, and the main path's
# shapes), and the ends of the head-dim range
FUSED_CASES = chip_smoke.FUSED_CASES + (
    (4, 16, 128, 128, chip_smoke.FUSED_MODES),
    (4, 16, 1, 8, chip_smoke.FUSED_MODES))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,S,D,names", FUSED_CASES)
def test_fused_kernel_matches_twin(card, B, N, S, D, names, dtype):
    q, k, v, pad, seg = attention_inputs(B, N, S, D, dtype, seed=S + D)
    masks = {"nomask": {}, "pad_mask": {"pad_mask": pad},
             "segment_ids": {"segment_ids": seg}}
    for name in names:
        mask = masks[name]
        mode = "segment" if mask else "nomask"
        before = fused.LAUNCHES[mode]
        out = fused.fused_attention(q, k, v, **mask)
        torch.cuda.synchronize()
        assert fused.LAUNCHES[mode] == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        assert torch.isfinite(out).all()
        check_attention(out, fused.fused_attention_reference(q, k, v, **mask),
                        _control(fused.fused_attention_reference, q, k, v,
                                 **mask), name)


def test_fused_kernel_refuses_non_contiguous_input(card):
    q, k, v, _, seg = attention_inputs(2, 16, 50, 64, torch.float32, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                              k, v, segment_ids=seg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,S,D", [(257, 16, 8, 64), (514, 16, 8, 64),
                                     (16, 16, 497, 64), (16, 16, 577, 64)])
def test_fused_kernel_at_the_new_towers_shapes(card, B, N, S, D, dtype):
    """B2's no-mask mode where the CoCa, EVA02 and LanguageBind towers
    take it: the video tower's temporal attention over 8 frames for one
    and two videos (257 and 514 rows: a 64-row query tile 7/8 idle), the
    audio tower's 497 tokens and EVA02-L-14-336's 577, in the projections'
    layout."""
    q, k, v, _, _ = attention_inputs(B, N, S, D, dtype, seed=B + S)
    before = fused.LAUNCHES["nomask"]
    _check_b2(*projection_views(q, k, v, "projection"), {"nomask": {}},
              dtype)
    assert fused.LAUNCHES["nomask"] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,S,D", [chip_smoke.DINO_B2_SHAPE,
                                     chip_smoke.OWL_B2_SHAPE])
def test_fused_kernel_at_the_detector_shapes(card, B, N, S, D, dtype):
    """B2's no-mask mode where the detector models take it: DINO
    ViT-S/16's blocks on one image (197 tokens, 6 heads) and OWL-ViT
    B/32's vision blocks on a batch of reranked hits (577 tokens), in the
    projections' layout."""
    q, k, v, _, _ = attention_inputs(B, N, S, D, dtype, seed=B + S)
    before = fused.LAUNCHES["nomask"]
    _check_b2(*projection_views(q, k, v, "projection"), {"nomask": {}},
              dtype)
    assert fused.LAUNCHES["nomask"] == before + 1


def test_fused_kernel_refuses_a_batch_past_its_grid():
    """The batch rides on grid.z, at most 65535 blocks: a larger B is a
    ValueError before any launch (on the CPU too, where the check stands
    alone), and B = 65535 passes it."""
    q = torch.zeros(fused.MAX_BATCH + 1, 1, 1, 8)
    with pytest.raises(ValueError, match="batch limit of 65535"):
        fused.check_kernel_inputs(q, q, q)
    fused.check_kernel_inputs(q[:-1], q[:-1], q[:-1])
    if torch.cuda.is_available():
        q = q.cuda()
        before = fused.LAUNCHES["nomask"]
        with pytest.raises(ValueError, match="batch limit"):
            fused.fused_attention(q, q, q)
        assert fused.LAUNCHES["nomask"] == before


B1_MODES = (("padding", fa.attention_padding, fa.attention_padding_reference),
            ("segment", fa.attention_segment, fa.attention_segment_reference))


def _check_b1(q, k, v, mask, dtype):
    for mode, kernel, plain in B1_MODES:
        before = fa.LAUNCHES[mode]
        out = kernel(q, k, v, mask)
        torch.cuda.synchronize()
        assert fa.LAUNCHES[mode] == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        assert is_projection_layout(out)
        assert torch.isfinite(out).all()
        check_attention(out, plain(q, k, v, mask),
                        _control(plain, q, k, v, mask), mode)


def _check_b2(q, k, v, masks, dtype):
    for name, mask in masks.items():
        out = fused.fused_attention(q, k, v, **mask)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == q.shape
        assert is_projection_layout(out)
        assert torch.isfinite(out).all()
        check_attention(out, fused.fused_attention_reference(q, k, v, **mask),
                        _control(fused.fused_attention_reference, q, k, v,
                                 **mask), name)


def _b2_masks(pad, seg):
    return {"nomask": {}, "pad_mask": {"pad_mask": pad},
            "segment_ids": {"segment_ids": seg}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", PROJECTION_LAYOUTS)
@pytest.mark.parametrize("S,D", [(128, 64), (17, 32), (257, 8), (512, 128)])
def test_kernel_reads_projection_layouts(card, S, D, layout, dtype):
    """B1 on the encoders' own layouts: views of a (B, S, N*D) projection
    and chunks of Stella's fused qkv projection."""
    q, k, v, pad, seg = attention_inputs(4, 3, S, D, dtype, seed=S + D)
    views = projection_views(q, k, v, layout)
    assert not views[0].is_contiguous()
    _check_b1(*views, pad, dtype)
    _check_b1(*views, seg, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", PROJECTION_LAYOUTS)
@pytest.mark.parametrize("S,D", [(257, 64), (50, 80), (730, 104)])
def test_fused_kernel_reads_projection_layouts(card, S, D, layout, dtype):
    q, k, v, pad, seg = attention_inputs(4, 3, S, D, dtype, seed=S + D)
    _check_b2(*projection_views(q, k, v, layout), _b2_masks(pad, seg), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 32])
@pytest.mark.parametrize("S", [1, 15, 17, 65, 257])
def test_kernel_ragged_seq_len(card, S, D, dtype):
    q, k, v, pad, seg = attention_inputs(4, 3, S, D, dtype, seed=S * D + 1)
    _check_b1(q, k, v, pad, dtype)
    _check_b1(q, k, v, seg, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [24, 40, 80, 104, 120])
@pytest.mark.parametrize("S", [1, 15, 17, 65, 257, 577, 730])
def test_fused_kernel_ragged_seq_len_and_head_dim(card, S, D, dtype):
    q, k, v, pad, seg = attention_inputs(4, 2, S, D, dtype, seed=S * D + 2)
    _check_b2(q, k, v, _b2_masks(pad, seg), dtype)


def _skip_case(name, S):
    """(B, S) int32 ids/mask rows that exercise each tile-skipping rule."""
    ids = np.zeros((4, S), dtype=np.int32)
    if name == "all_pad_row":
        # padding: an all-pad row among real ones of other lengths
        for b, n in enumerate((S, 0, 70, 5)):
            ids[b, :n] = 1
    elif name == "pad_queries_in_block":
        # segment: the first query block holds real and pad (0) queries;
        # later blocks hold only real ones
        ids[:, :40] = 1
        ids[:, 64:130] = 2
        ids[:, 130:S - 20] = 3
        ids[1, 20:64] = 0
        ids[2] = 0
        ids[2, 100:110] = 4
    elif name == "straddling_segments":
        # runs of 50, 30, 70, 100, ... across the 64-key tile edges
        pos, sid = 0, 1
        for run in (50, 30, 70, 100, 13, 60, 90):
            ids[:, pos:pos + run] = sid
            pos, sid = pos + run, sid + 1
        ids[3, 60:70] = 0
    elif name == "non_monotone":
        # ids revisit earlier values and step down
        runs = ((3, 40), (1, 50), (3, 30), (2, 60), (1, 10), (5, 70),
                (2, 40), (0, 10), (4, 90))
        pos = 0
        for sid, run in runs:
            ids[:, pos:pos + run] = sid
            pos += run
        ids[1] = ids[1, ::-1]
    elif name == "padding_hole":
        # a wholly padded 64-key tile in the middle of a row
        ids[:, :64] = 1
        ids[:, 128:S - 30] = 1
        ids[1, 128:] = 0
        ids[2, :] = 1
        ids[2, 64:192] = 0
    return ids


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["all_pad_row", "pad_queries_in_block",
                                  "straddling_segments", "non_monotone",
                                  "padding_hole"])
def test_tile_skipping_keeps_every_row(card, name, dtype):
    """Each skipping rule's edge through every masked mode: B1 padding and
    segment, B2 segment ids and pad mask, on the encoders' layout."""
    S = 400
    q, k, v, _, _ = attention_inputs(4, 3, S, 64, dtype, seed=len(name))
    q, k, v = projection_views(q, k, v, "projection")
    ids = torch.from_numpy(_skip_case(name, S)).to(card)
    _check_b1(q, k, v, ids, dtype)
    _check_b2(q, k, v, {"pad_mask": {"pad_mask": ids},
                        "segment_ids": {"segment_ids": ids}}, dtype)


BF16_LOOPS = ("wgmma", "mma_sync")


def _check_loop(q, k, v, ids, loop):
    """Both B1 modes (S up to B1's 512) and B2's three modes on the bf16
    tile loop ``loop``, forced, each counted on that loop."""
    S = q.shape[2]
    b1 = B1_MODES if S <= fa.MAX_SEQ_LEN else ()
    for mode, _, plain in b1:
        before = dict(fa.LOOP_LAUNCHES)
        out = fa._launch(q, k, v, ids, mode, loop=loop)
        torch.cuda.synchronize()
        assert fa.LOOP_LAUNCHES[loop] == before[loop] + 1
        assert out.shape == q.shape and is_projection_layout(out)
        assert torch.isfinite(out).all()
        check_attention(out, plain(q, k, v, ids),
                        _control(plain, q, k, v, ids), f"{mode} {loop}")
    for name, mask in _b2_masks(ids, ids).items():
        segment = fused._segment_ids(mask.get("pad_mask"),
                                     mask.get("segment_ids"))
        before = dict(fused.LOOP_LAUNCHES)
        out = fused._launch(q, k, v, segment, loop=loop)
        torch.cuda.synchronize()
        assert fused.LOOP_LAUNCHES[loop] == before[loop] + 1
        assert out.shape == q.shape and is_projection_layout(out)
        assert torch.isfinite(out).all()
        ref = fused.fused_attention_reference
        check_attention(out, ref(q, k, v, **mask),
                        _control(ref, q, k, v, **mask), f"{name} {loop}")


# the wgmma loop's edges: 64-key tiles, 64-row warpgroups, 128-row blocks
TILE_EDGES = (1, 7, 63, 64, 65, 127, 128, 129, 255, 257, 497, 577, 729)


@pytest.mark.parametrize("S", TILE_EDGES)
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_wgmma_loop_matches_twin_at_every_head_dim(card, D, S):
    """The wgmma loop, forced, at every head dim (8 to 128, one and two
    64-column panels) across its tile edges: B1 padding and segment (S up
    to 512), B2 no mask, pad mask and segment ids. The ids are the packed
    segments at odd S past 16 and the padding mask elsewhere: below 16
    tokens attention_inputs packs one-token segments, whose rows no
    softmax scale moves, so the scale control could not fail there."""
    q, k, v, pad, seg = attention_inputs(2, 2, S, D, torch.bfloat16,
                                         seed=S + D)
    _check_loop(q, k, v, seg if S % 2 and S > 16 else pad, "wgmma")


@pytest.mark.parametrize("loop", BF16_LOOPS)
@pytest.mark.parametrize("layout", PROJECTION_LAYOUTS)
@pytest.mark.parametrize("S,D", [(129, 64), (257, 104), (65, 32)])
def test_bf16_loops_read_projection_layouts(card, S, D, layout, loop):
    """Both bf16 loops on the encoders' layouts, every mask policy."""
    q, k, v, pad, seg = attention_inputs(3, 4, S, D, torch.bfloat16,
                                         seed=S * D)
    views = projection_views(q, k, v, layout)
    _check_loop(*views, pad, loop)
    _check_loop(*views, seg, loop)


@pytest.mark.parametrize("loop", BF16_LOOPS)
@pytest.mark.parametrize("name", ["all_pad_row", "pad_queries_in_block",
                                  "straddling_segments", "non_monotone",
                                  "padding_hole"])
def test_tile_skipping_on_both_bf16_loops(card, name, loop):
    """Each skipping rule's edge, the all-pad and pad-query rows among
    them, on each bf16 loop forced (the wgmma loop's blocks are 128 query
    rows where the mma.sync loop's are 64)."""
    S = 400
    q, k, v, _, _ = attention_inputs(4, 3, S, 64, torch.bfloat16,
                                     seed=len(name))
    q, k, v = projection_views(q, k, v, "projection")
    _check_loop(q, k, v, torch.from_numpy(_skip_case(name, S)).to(card),
                loop)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,D", [(8, 64), (16, 128), (24, 32), (33, 32),
                                 (64, 128), (65, 128), (257, 64), (577, 64)])
def test_wrappers_launch_the_loop_tile_loop_picks(card, S, D, dtype):
    """The public entry points count one launch on tile_loop's loop, fp32
    always on the FMA loop (B1 up to its 512 tokens); a loop the dtype does
    not take is refused before any launch."""
    q, k, v, pad, _ = attention_inputs(2, 2, S, D, dtype, seed=S)
    loop = fa.tile_loop(S, D, dtype)
    calls = [(fused, lambda: fused.fused_attention(q, k, v))]
    if S <= fa.MAX_SEQ_LEN:
        calls.append((fa, lambda: fa.attention_padding(q, k, v, pad)))
    for module, call in calls:
        before = dict(module.LOOP_LAUNCHES)
        call()
        torch.cuda.synchronize()
        assert {name: n - before[name] for name, n in
                module.LOOP_LAUNCHES.items() if n != before[name]} == {
                    loop: 1}
    wrong = "wgmma" if dtype == torch.float32 else "fma"
    before = dict(fused.LOOP_LAUNCHES)
    with pytest.raises(ValueError, match="tile loop"):
        fused._launch(q, k, v, None, loop=wrong)
    assert fused.LOOP_LAUNCHES == before


def _cuobjdump():
    found = shutil.which("cuobjdump")
    if found:
        return found
    candidate = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    if not os.path.isfile(candidate):
        pytest.skip("needs cuobjdump to read the built library")
    return candidate


def test_bf16_attention_instances_run_on_tensor_cores(card):
    """The bf16 instances of the mma.sync tile loop (B1 and B2) hold HMMA
    (the tensor cores' mma.sync), those of the wgmma loop HGMMA (the
    warpgroup MMA; "HMMA" is no substring of it); the fp32 instances hold
    neither (their exact FMA loop)."""
    library = _build.load_library()
    sass = subprocess.run([_cuobjdump(), "-sass", library._name],
                          capture_output=True, text=True, check=True).stdout
    functions = re.split(r"\n\s*Function : ", sass)[1:]
    bf16 = [f for f in functions
            if "attention_tile_kernelI13__nv_bfloat16" in f.split()[0]]
    fp32 = [f for f in functions if "attention_tile_kernelIf" in f.split()[0]]
    wgmma = [f for f in functions if "attention_sm90_kernel" in f.split()[0]]
    # B1 and B2: eight padded head dims in each of two modes, per loop
    assert len(bf16) == len(fp32) == len(wgmma) == 2 * 8 + 2 * 8
    assert all("HMMA" in f for f in bf16)
    assert all("HGMMA" in f for f in wgmma)
    assert not any("HMMA" in f or "HGMMA" in f for f in fp32)


def _check_w8a8(M, K, N, dtype, seed):
    """B3 equals its twin bit for bit and counts one launch."""
    x, w_q, w_scale, bias = w8a8_inputs(M, K, N, dtype, seed=seed)
    before = qm.LAUNCHES["w8a8"]
    out = qm.w8a8_matmul(x, w_q, w_scale, bias)
    torch.cuda.synchronize()
    assert qm.LAUNCHES["w8a8"] == before + 1
    assert out.dtype == dtype and tuple(out.shape) == (M, N)
    assert torch.isfinite(out).all()
    assert torch.equal(out, qm.w8a8_matmul_reference(x, w_q, w_scale, bias))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", chip_smoke.W8A8_WIDTHS)
@pytest.mark.parametrize("M", [1, 32, 37, 4096, 17408])
def test_w8a8_kernel_matches_twin(card, M, K, N, dtype):
    """B3 against its twin over the registry's widths: exactly equal."""
    _check_w8a8(M, K, N, dtype, seed=M + K + N)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", chip_smoke.W8A8_RAGGED)
def test_w8a8_kernel_ragged_edges(card, M, K, N, dtype):
    """K tails shorter than a 128-byte stage, output rows whose stride is
    not a multiple of 16 bytes (the element-wise store path), tiles that
    overhang M and N, and a query's M = 1 and 32."""
    _check_w8a8(M, K, N, dtype, seed=M * N)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(4096, 5120, 1280), (37, 5120, 64),
                                   (5, 4112, 16), (300, 131072, 24)])
def test_w8a8_kernel_rows_longer_than_a_warp_holds(card, M, K, N, dtype):
    """K over 4096 (ROADMAP C1): the two-pass row quantizer, up to MAX_K,
    equal to the twin bit for bit."""
    _check_w8a8(M, K, N, dtype, seed=M + K)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [40, 200])
def test_int8_layer_pads_k_on_the_card(card, K, dtype):
    """A K that is not a multiple of 16: Int8Linear's zero-padded weights
    through the kernel equal the twin on the unpadded weights."""
    from marqo_tpu_torch.models import bert
    rng = np.random.default_rng(K)
    weight = torch.from_numpy(0.05 * rng.standard_normal((96, K)).astype(
        np.float32)).to(card, dtype)
    bias = torch.zeros(96, device=card, dtype=dtype)
    x = torch.from_numpy(rng.standard_normal((33, K)).astype(
        np.float32)).to(card, dtype)
    layer = bert.Int8Linear.from_weight(weight, bias)
    before = qm.LAUNCHES["w8a8"]
    out = layer(x)
    torch.cuda.synchronize()
    assert qm.LAUNCHES["w8a8"] == before + 1
    w_q, w_scale = bert.quantize_weight(weight)
    assert torch.equal(out, bert.int8_linear_reference(x, w_q, w_scale, bias))


def _gemm_tile_widths(fn) -> set:
    """The tile widths (BN) of the GEMM instances one call of ``fn``
    launches, read from the kernels' names in a torch.profiler trace
    (demangled, w8a8_gemm<float, 64>, or mangled, w8a8_gemmIfLi64E)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    widths = set()
    for event in prof.key_averages():
        found = re.search(r"w8a8_gemm(?:<\w+, |I\w*?Li)(\d+)", event.key)
        if found:
            widths.add(int(found.group(1)))
    return widths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,tile_n", [
    (1, 16, 1, 64), (37, 80, 130, 64), (32, 768, 3072, 64),
    (1024, 3072, 768, 64), (4096, 3072, 770, 128),
    (17408, 768, 3072, 128)])
def test_w8a8_every_instance_matches_twin(card, M, K, N, tile_n, dtype):
    """Both GEMM instances, on shapes either side of the kernel's rule
    (128-wide tiles where they fill the SMs, else 64-wide), ragged and on
    the main path, each launching the instance named; K = 3072 wraps even
    the deepest ring (8 stages) three times per tile."""
    _check_w8a8(M, K, N, dtype, seed=M + N + tile_n)
    x, w_q, w_scale, bias = w8a8_inputs(M, K, N, dtype, seed=0)
    assert _gemm_tile_widths(
        lambda: qm.w8a8_matmul(x, w_q, w_scale, bias)) == {tile_n}


def test_w8a8_gemm_instances_run_on_warpgroup_mma(card):
    """Every GEMM instance of B3 (two tile widths, fp32 and bf16 out)
    holds the warpgroup MMA on int8 (IGMMA) and no mma.sync (IMMA)."""
    library = _build.load_library()
    sass = subprocess.run([_cuobjdump(), "-sass", library._name],
                          capture_output=True, text=True, check=True).stdout
    functions = re.split(r"\n\s*Function : ", sass)[1:]
    gemm = [f for f in functions if "w8a8_gemm" in f.split()[0]]
    assert len(gemm) == 2 * 2
    assert all("IGMMA" in f for f in gemm)
    assert not any("IMMA" in f for f in gemm)


def test_w8a8_kernel_refuses_what_it_does_not_take(card):
    x, w_q, w_scale, bias = w8a8_inputs(8, 64, 32, torch.float32, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        qm.w8a8_matmul(x.T.contiguous().T, w_q, w_scale, bias)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.empty(8 * 64 + 1, device=x.device)
        qm.w8a8_matmul(flat[1:].view(8, 64), w_q, w_scale, bias)
    with pytest.raises(ValueError, match="multiple of 16"):
        qm.w8a8_matmul(x[:, :40].contiguous(), w_q[:, :40].contiguous(),
                       w_scale, bias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_a_tensor_parallel_shard_shape(card, dtype):
    """B1, both modes, where the (2, 2) serving mesh gives it the e5-base
    encoder: 6 of its 12 heads a tp shard, 16 rows a dp group, in the
    shard's projection layout."""
    B, N, S, D = chip_smoke.MESH_B1_SHAPE
    q, k, v, pad, seg = attention_inputs(B, N, S, D, dtype, seed=B + N)
    views = projection_views(q, k, v, "projection")
    _check_b1(*views, pad, dtype)
    _check_b1(*views, seg, dtype)


def test_virtual_mesh_encode_matches_unsharded(card):
    """The e5-base-width bf16 encoder over a (2, 2) virtual mesh of the
    card (parallel/): its tp shards through B1 and the batch over dp,
    padded and packed, 12 x 2 x 2 B1 launches a batch; every row against
    the unsharded encoder on the same weights (cosine >= 0.999)."""
    from marqo_tpu_torch.models import bert
    from marqo_tpu_torch.ops.packing import pack_sequences
    from marqo_tpu_torch.parallel.encode import make_sharded_encode
    from marqo_tpu_torch.parallel.mesh import (create_mesh, shard_params,
                                               split_batch)
    config = bert.TextEncoderConfig(**chip_smoke.E5_BASE)
    encoder = bert.init_encoder(
        config, torch.Generator(device=card).manual_seed(0),
        dtype=torch.bfloat16, device=card)
    mesh = create_mesh([torch.device("cuda", 0)] * 4, shape=(2, 2))
    sharded = shard_params(encoder, mesh)
    rng = np.random.default_rng(0)
    B, S = 32, 128
    lengths = rng.integers(4, S + 1, B)
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
    ids = (rng.integers(5, config.vocab_size, (B, S)) * mask).astype(
        np.int32)
    launches = 4 * config.num_layers
    with torch.inference_mode():
        before = fa.LAUNCHES["padding"]
        out = make_sharded_encode(mesh, config, torch.bfloat16)(
            sharded, ids, mask)
        assert fa.LAUNCHES["padding"] == before + launches
        ref = bert.encode_tokens(encoder, torch.from_numpy(ids).to(card),
                                 torch.from_numpy(mask).to(card))
        assert torch.nn.functional.cosine_similarity(out, ref).min() >= \
            0.999
        packed = pack_sequences([ids[i, :lengths[i]] for i in range(B)],
                                seq_len=S, row_buckets=[16, 32])
        rows = (packed.input_ids, packed.segment_ids, packed.positions,
                packed.seq_index)
        n = packed.n_sequences
        before = fa.LAUNCHES["segment"]
        parts = [bert.packed_segment_sums(replica, *group, n) for
                 replica, group in zip(sharded, split_batch(mesh, *rows))]
        assert fa.LAUNCHES["segment"] == before + launches
        out = bert.pool_segment_sums(sum(p[0] for p in parts),
                                     sum(p[1] for p in parts), config)
        ref = bert.encode_tokens_packed(
            encoder, *(torch.from_numpy(a).to(card) for a in rows), n)
        assert torch.nn.functional.cosine_similarity(out, ref).min() >= \
            0.999
