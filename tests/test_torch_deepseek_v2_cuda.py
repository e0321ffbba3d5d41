"""DeepSeek-V2's kernels and model on the card: B1's causal modes at the
latent attention's widths (q/k 192, v 128) against their twin, the
grouped expert GEMM against its twin at the bulk-ingest cell's token
counts, a small model at the kernels' widths through the graphed path
against the float32 reference, the expert layer's SwiGLU and combine
passes (csrc/moe_glue.cu) against their twins at the cell's shapes, the
norm and RoPE passes (csrc/decoder_glue.cu) against theirs, and B1's
existing padding and segment times at the encoders' shape against
PERF.md's kernel table. Skips
without an sm_90 CUDA device and nvcc; on a Hopper host run

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_deepseek_v2_cuda.py

Tolerances: attention as chip_smoke.py's ``check_attention`` (fp32 |err|
<= 1e-5; bf16 |err| <= 4e-3 + 1e-2 |ref|, which the twin with a softmax
scale off by 10% must fail); the grouped GEMM's bf16 output against the
twin's (cuBLAS per group, another summation order): 1e-2 of the output's
largest magnitude, which a group's rows through another group's weight
must fail. The SwiGLU pass against silu(gate) * up in fp32 rounded once:
one bf16 ulp (at most 2^-7 of the value: the card's expf and the CPU's
exp may round a value to either side), and against the twin, which rounds
twice, two; the gate and up halves swapped must fail. The combine pass against
the fp32-weighted sum: its one rounding (2^-8 of the value) plus 1e-5 of
the terms' magnitudes (fp32 sums in another order); each token's weights
rotated by one expert must fail. The norm pass: its sum bit for bit as
``x + delta`` rounds it, its normed rows within two bf16 ulps of the twin
(fp32 sums of squares in another order and rsqrt's rounding, each then
rounded twice); the scale shifted by one column must fail. The RoPE pass
bit for bit (each fp32 product, sum and difference rounded on its own, as
the twin's separate kernels round them); the rotation reversed must
differ.
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import (DSV2_SCALE, SCALE_CONTROL, attention_excess,
                        attention_inputs, check_attention, mla_inputs,
                        queued_ms)
from marqo_tpu_torch.ops import _build
from marqo_tpu_torch.ops import decoder_glue as glue
from marqo_tpu_torch.ops import flash_attention as fa
from marqo_tpu_torch.ops import launches, moe

pytestmark = pytest.mark.cuda

# PERF.md's kernel table: B1 at (256, 12, 128, 64) bf16, card ms
KERNEL_TABLE_MS = {"padding": 0.0764, "segment": 0.0908}
SCALE = DSV2_SCALE


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
@pytest.mark.parametrize("S", [16, 64, 128, 200, 256, 512])
@pytest.mark.parametrize("mode", ["padding", "segment"])
def test_causal_kernel_matches_twin(card, mode, S, dtype):
    q, k, v, pad, seg = mla_inputs(6, 16, S, dtype, seed=S)
    kernel, plain, mask = {
        "padding": (fa.attention_padding, fa.attention_padding_reference,
                    pad),
        "segment": (fa.attention_segment, fa.attention_segment_reference,
                    seg)}[mode]
    before = fa.LAUNCHES[f"{mode}_causal"]
    out = kernel(q, k, v, mask, causal=True, scale=SCALE)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[f"{mode}_causal"] == before + 1
    assert out.shape == (6, 16, S, 128) and out.dtype == dtype
    assert out.transpose(1, 2).is_contiguous()
    ref = plain(q, k, v, mask, causal=True, scale=SCALE)
    control = plain(q * SCALE_CONTROL, k, v, mask, causal=True, scale=SCALE) \
        if dtype == torch.bfloat16 else None
    check_attention(out, ref, control, f"{mode} causal")
    # and it is causal: the acausal twin is far off
    acausal = plain(q, k, v, mask, scale=SCALE)
    assert attention_excess(acausal.to(dtype), ref) > 4e-3


def group_offsets(T, per_token, groups, seed):
    """The groups' end offsets of T tokens sent to ``per_token`` groups
    each, a few tokens routed nowhere (pad)."""
    g = torch.Generator().manual_seed(seed)
    choice = torch.stack([torch.randperm(groups, generator=g)[:per_token]
                          for _ in range(T)])
    choice[torch.randperm(T, generator=g)[:T // 50]] = groups
    sizes = torch.bincount(choice.reshape(-1), minlength=groups + 1)
    return torch.cumsum(sizes[:groups], 0).to(torch.int32)


@pytest.mark.parametrize("T", [2048, 16384])
def test_grouped_mm_matches_twin(card, T):
    """At the cell's shapes: 64 routed experts, 6 rows a token, gate-up
    (2 x 1408 by 2048) then down (2048 by 1408)."""
    G, H, F = 64, 2048, 1408
    offsets = group_offsets(T, 6, G, seed=T).cuda()
    g = torch.Generator(device="cuda").manual_seed(T)
    rows = torch.randn(T * 6, H, generator=g, device="cuda").to(
        torch.bfloat16)
    for weight in (torch.randn(G, 2 * F, H, generator=g, device="cuda"),
                   torch.randn(G, H, F, generator=g, device="cuda")):
        weight = (weight * 0.02).to(torch.bfloat16)
        x = rows[:, :weight.shape[2]].contiguous()
        before = moe.LAUNCHES["grouped_mm"]
        out = moe.grouped_mm(x, weight, offsets)
        torch.cuda.synchronize()
        assert moe.LAUNCHES["grouped_mm"] == before + 1
        twin = moe.grouped_mm_reference(x, weight, offsets)
        end = int(offsets[-1])
        scale = float(twin[:end].float().abs().max())
        err = float((out[:end].float() - twin[:end].float()).abs().max())
        assert err <= 1e-2 * scale, (err, scale)
        # a control: the groups' weights shifted by one must fail
        shifted = moe.grouped_mm_reference(x, weight.roll(1, 0), offsets)
        assert float((shifted[:end].float() - twin[:end].float()).abs()
                     .max()) > 1e-2 * scale


def test_expert_layer_matches_its_cpu_twin(card):
    """The whole layer on the card (grouped GEMM, sort, combine) against the
    CPU path at the same bf16 inputs, at 4,096 tokens of hidden 2048."""
    T, H, F, E = 4096, 2048, 1408, 64
    g = torch.Generator().manual_seed(3)
    x = torch.randn(T, H, generator=g).to(torch.bfloat16)
    router = (0.02 * torch.randn(E, H, generator=g)).to(torch.bfloat16)
    gate_up = (0.02 * torch.randn(E, 2 * F, H, generator=g)).to(
        torch.bfloat16)
    down = (0.02 * torch.randn(E, H, F, generator=g)).to(torch.bfloat16)
    valid = torch.ones(T, dtype=torch.bool)
    valid[-100:] = False
    counts = torch.zeros(E, dtype=torch.int64, device="cuda")
    before = dict(moe.LAUNCHES)
    out = moe.expert_layer(*(t.cuda() for t in (x, valid, router, gate_up,
                                                down)), 6, counts=counts)
    twin = moe.expert_layer(x, valid, router, gate_up, down, 6)
    torch.cuda.synchronize()
    assert {name: moe.LAUNCHES[name] - before[name] for name in before} == \
        {"grouped_mm": 2, "swiglu": 1, "combine": 1}
    assert int(counts.sum()) == 6 * (T - 100)
    scale = float(twin.float().abs().max())
    err = float((out.cpu().float() - twin.float()).abs().max())
    assert err <= 2e-2 * scale, (err, scale)
    assert not out[-100:].any()


# --- the expert layer's SwiGLU and combine passes ---------------------------------

# the cell's shapes: a packed forward's 16,384 token slots, ~9% pad, k 6 of
# 64 routed experts of 1,408, the shared experts' 2,816, layer 0's 10,944,
# hidden 2,048
SLOTS, TOP_K, HIDDEN = 16384, 6, 2048
REAL_TOKENS = 15000


def ulp_excess(out, expected, ulps):
    """The largest |out - expected| beyond ``ulps`` bf16 ulps of
    |expected| (an ulp at most 2^-7 of a value; <= 0 inside)."""
    out, expected = out.float(), expected.float()
    return float(((out - expected).abs() - ulps * 2 ** -7 *
                  expected.abs()).max())


def swiglu_rows(rows, W, seed, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (3 * torch.randn(rows, 2 * W, generator=g, device="cuda")).to(dtype)


def fused_swiglu(h):
    gate, up = h.float().chunk(2, dim=-1)
    return (torch.nn.functional.silu(gate) * up).to(h.dtype)


@pytest.mark.parametrize("rows,W,count", [
    (SLOTS * TOP_K, 1408, REAL_TOKENS * TOP_K),   # routed, real rows only
    (SLOTS * TOP_K, 1408, None),
    (SLOTS, 2816, None),                          # the shared experts
    (SLOTS, 10944, None),                         # layer 0
    (1, 1408, 1),
    (7, 1408, 0)])
def test_swiglu_kernel_matches_twin(card, rows, W, count):
    h = swiglu_rows(rows, W, seed=W + rows)
    live = rows if count is None else count
    # rows past the count hold NaN: read, they would show
    h[live:] = float("nan")
    before = moe.LAUNCHES["swiglu"]
    out = moe.swiglu(h, None if count is None else
                     torch.tensor([count], dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    assert moe.LAUNCHES["swiglu"] == before + 1
    assert out.shape == (rows, W) and out.dtype == torch.bfloat16
    got, real = out[:live], h[:live]
    assert bool(torch.isfinite(got).all())
    if not live:
        return
    assert ulp_excess(got, fused_swiglu(real), 1) <= 0
    assert ulp_excess(got, moe.swiglu_reference(real), 2) <= 0
    gate, up = real.chunk(2, dim=-1)
    assert ulp_excess(got, fused_swiglu(torch.cat([up, gate], -1)), 2) > 0


def combine_inputs(T, k, H, real, seed, dtype=torch.bfloat16):
    """y in expert order with NaN past the real rows, back (a random
    permutation with each valid token's rows before every pad token's),
    fp32 weights, valid with the tokens past ``real`` pad."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    valid = torch.zeros(T, dtype=torch.bool, device="cuda")
    valid[torch.randperm(T, generator=g, device="cuda")[:real]] = True
    key = torch.rand(T, k, generator=g, device="cuda") + (~valid)[:, None]
    order = torch.argsort(key.reshape(-1), stable=True)
    back = moe.back_rows(order).view(T, k)
    y = torch.randn(T * k, H, generator=g, device="cuda").to(dtype)
    y[real * k:] = float("nan")
    weights = torch.rand(T, k, generator=g, device="cuda") / k
    return y, back, weights, valid


def combine_excess(out, y, back, weights, valid):
    """|out - sum_j w y| beyond one rounding of the value and 1e-5 of the
    terms' magnitudes, over the valid tokens (<= 0 inside)."""
    T, k = back.shape
    terms = weights[..., None] * y[back.reshape(-1).long()].view(
        T, k, -1).float()
    exact = terms.sum(1)
    err = (out.float() - exact).abs() - 2 ** -8 * exact.abs() - \
        1e-5 * terms.abs().sum(1)
    return float(err[valid].max())


@pytest.mark.parametrize("T,k,H,real", [
    (SLOTS, TOP_K, HIDDEN, REAL_TOKENS),
    (SLOTS, TOP_K, HIDDEN, SLOTS),
    (4096, 2, HIDDEN, 3000),
    (1, TOP_K, HIDDEN, 1),
    (3, moe.MAX_TOP_K, 64, 2)])
def test_combine_kernel_matches_twin(card, T, k, H, real):
    y, back, weights, valid = combine_inputs(T, k, H, real, seed=T + k)
    before = moe.LAUNCHES["combine"]
    out = moe.combine(y, back, weights, valid)
    torch.cuda.synchronize()
    assert moe.LAUNCHES["combine"] == before + 1
    assert out.shape == (T, H) and out.dtype == torch.bfloat16
    # pad tokens zero, their (NaN) rows never read
    assert bool(torch.isfinite(out).all()) and not out[~valid].any()
    assert combine_excess(out, y, back, weights, valid) <= 0
    twin = moe.combine_reference(y, back, weights, valid)
    assert float((out.float() - twin.float()).abs().max()) <= \
        2 ** -6 * float(twin.float().abs().max())
    assert combine_excess(out, y, back, weights.roll(1, 1), valid) > 0


def _captured(fn):
    """A CUDA graph of ``fn()`` (warmed on a side stream) and its output."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def test_graphed_swiglu_reads_the_count_at_each_replay(card):
    """The stale-input control: one capture, the count changed in place
    between replays; each replay writes exactly the rows below the count it
    finds, the rest keep what they held."""
    rows, W = 6000, 1408
    h = swiglu_rows(rows, W, seed=11)
    count = torch.tensor([1000], dtype=torch.int32, device="cuda")
    graph, out = _captured(lambda: moe.swiglu(h, count))
    expected = fused_swiglu(h)
    for live in (1000, 4500, 0, rows, 17):
        count.fill_(live)
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        if live:
            assert ulp_excess(out[:live], expected[:live], 1) <= 0
        assert bool(out[live:].isnan().all()), live


def test_graphed_combine_reads_new_inputs_at_each_replay(card):
    T, k, H = 2048, TOP_K, HIDDEN
    y, back, weights, valid = combine_inputs(T, k, H, 1500, seed=1)
    graph, out = _captured(lambda: moe.combine(y, back, weights, valid))
    for seed, real in ((2, 1500), (3, 700), (4, T)):
        new = combine_inputs(T, k, H, real, seed=seed)
        for static, fresh in zip((y, back, weights, valid), new):
            static.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        assert not out[~valid].any() and bool(torch.isfinite(out).all())
        assert combine_excess(out, y, back, weights, valid) <= 0


def test_passes_refuse_what_the_kernels_do_not_take(card):
    h = swiglu_rows(64, 1408, seed=0)
    for dtype in (torch.float16, torch.float32):
        with pytest.raises(ValueError, match="must be bf16"):
            moe.swiglu(h.to(dtype))
    with pytest.raises(ValueError, match="contiguous"):
        moe.swiglu(h.T.contiguous().T)
    with pytest.raises(ValueError, match="int32"):
        moe.swiglu(h, torch.tensor([3], device="cuda"))
    y, back, weights, valid = combine_inputs(64, TOP_K, HIDDEN, 60, seed=0)
    for dtype in (torch.float16, torch.float32):
        with pytest.raises(ValueError, match="must be bf16"):
            moe.combine(y.to(dtype), back, weights, valid)
    wide = combine_inputs(4, moe.MAX_TOP_K + 1, 64, 4, seed=0)
    with pytest.raises(ValueError, match="k <= 8"):
        moe.combine(*wide)
    with pytest.raises(ValueError, match="contiguous"):
        moe.combine(y.T.contiguous().T, back, weights, valid)
    with pytest.raises(ValueError, match="back must be"):
        moe.combine(y, back.long(), weights, valid)
    with pytest.raises(ValueError, match="weights must"):
        moe.combine(y, back, weights.to(torch.bfloat16), valid)
    with pytest.raises(ValueError, match="share a device"):
        moe.combine(y, back.cpu(), weights, valid)


# --- the norm and RoPE passes (csrc/decoder_glue.cu) -------------------------------

LATENT, ROPE, HEADS, NOPE, V = 512, 64, 16, 128, 128


def norm_inputs(rows, W, delta, seed, stride=None):
    """x (rows, W) bf16, as a slice of (rows, stride) where given; delta
    or None; a bf16 scale near 1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (3 * torch.randn(rows, stride or W, generator=g, device="cuda")).to(
        torch.bfloat16)[:, :W]
    d = torch.randn(rows, W, generator=g, device="cuda").to(torch.bfloat16) \
        if delta else None
    scale = (1 + 0.1 * torch.randn(W, generator=g, device="cuda")).to(
        torch.bfloat16)
    return x, d, scale


@pytest.mark.parametrize("rows,W,delta,keep,stride,case", [
    (SLOTS, HIDDEN, True, True, None, "residual"),   # a residual add kept
    (SLOTS, HIDDEN, False, True, None, "plain"),     # layer 0's input norm
    (SLOTS, HIDDEN, True, False, None, "nosum"),     # the final norm
    (SLOTS, LATENT, False, True, LATENT + ROPE, "strided"),  # the latent
    (1, HIDDEN, True, True, None, "residual"),
    (5, 16, True, True, None, "residual"),           # one vector a row
    (300, 1024, True, True, None, "residual")])      # four vectors a lane
def test_add_rms_norm_kernel_matches_twin(card, rows, W, delta, keep,
                                          stride, case):
    """The sum bit for bit as ``x + delta`` rounds it; the normed rows
    within two bf16 ulps of the twin (fp32 sums of squares in another
    order, rsqrt's rounding, then two roundings); the scale shifted by one
    column must fail. The launch counted under its case's name."""
    x, d, scale = norm_inputs(rows, W, delta, seed=rows + W, stride=stride)
    before = glue.LAUNCHES["add_rms_norm"]
    with launches.recording() as log:
        total, normed = glue.add_rms_norm(x, d, scale, 1e-6, keep)
    launches.add(log)
    torch.cuda.synchronize()
    assert glue.LAUNCHES["add_rms_norm"] == before + 1
    assert [(launch.name, launch.shape) for launch in log] == [
        (f"add_rms_norm_{case}", (rows, W, stride or W))]
    assert normed.shape == x.shape and normed.dtype == torch.bfloat16
    twin_sum, twin = glue.add_rms_norm_reference(x, d, scale, 1e-6, keep)
    if not keep:
        assert total is None
    elif d is None:
        assert total is x
    else:
        assert torch.equal(total, twin_sum)
    assert bool(torch.isfinite(normed).all())
    assert ulp_excess(normed, twin, 2) <= 0
    _, shifted = glue.add_rms_norm_reference(x, d, scale.roll(1), 1e-6)
    assert ulp_excess(normed, shifted, 2) > 0


def rope_inputs(B, S, positions, seed):
    """q and kv_b at the cell's widths, the shared RoPE key as a slice of
    kv_a's (B, S, 576) output, and the tables of ``positions``."""
    from tests.deepseek_v2_checkpoint import TINY

    from marqo_tpu_torch.models import deepseek_v2 as dsv2
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, S, HEADS, NOPE + ROPE, generator=g,
                    device="cuda").to(torch.bfloat16)
    kv_b = torch.randn(B, S, HEADS, NOPE + V, generator=g,
                       device="cuda").to(torch.bfloat16)
    key = torch.randn(B, S, LATENT + ROPE, generator=g, device="cuda").to(
        torch.bfloat16)[..., LATENT:]
    c = dsv2.config_from_hf(dict(TINY, qk_nope_head_dim=NOPE,
                                 qk_rope_head_dim=ROPE))
    cos, sin = dsv2.rope_tables(positions.cuda(), c)
    return q, kv_b, key, cos, sin


def segment_positions(B, S, seed):
    """Positions that restart at segment starts (~110 tokens apart)."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.arange(S).expand(B, S)
    start = torch.rand(B, S, generator=g) < 1 / 110
    start[:, 0] = True
    return idx - torch.cummax(torch.where(start, idx, 0), dim=1).values


@pytest.mark.parametrize("B,S,layout", [(64, 256, "packed"),
                                        (1, 128, "padded"),
                                        (3, 5, "packed")])
def test_mla_rope_kernel_matches_twin(card, B, S, layout):
    """q rotated in place and k assembled, bit for bit the twin's (each
    product, sum and difference rounded in fp32, then once to bf16);
    the rotation reversed must differ."""
    positions = segment_positions(B, S, seed=S) if layout == "packed" else \
        torch.arange(S).expand(B, S)
    q, kv_b, key, cos, sin = rope_inputs(B, S, positions, seed=B + S)
    q_twin, q_reversed = q.clone(), q.clone()
    before = glue.LAUNCHES["mla_rope"]
    k = glue.mla_rope(q, kv_b, key, cos, sin)
    torch.cuda.synchronize()
    assert glue.LAUNCHES["mla_rope"] == before + 1
    assert k.shape == q.shape and k.dtype == torch.bfloat16
    k_twin = glue.mla_rope_reference(q_twin, kv_b, key, cos, sin)
    assert torch.equal(k, k_twin) and torch.equal(q, q_twin)
    k_reversed = glue.mla_rope_reference(q_reversed, kv_b, key, cos, -sin)
    assert not torch.equal(k, k_reversed) and not torch.equal(q, q_reversed)


def test_graphed_passes_read_new_inputs_at_each_replay(card):
    """One capture of a residual add + norm, the latent norm and RoPE; the
    inputs changed in place between replays; each replay computes the
    twins' values of the inputs it finds."""
    T, B, S = 2048, 8, 256
    x, d, scale = norm_inputs(T, HIDDEN, True, seed=1)
    kv = torch.zeros(T, LATENT + ROPE, dtype=torch.bfloat16, device="cuda")
    kv_scale = norm_inputs(1, LATENT, False, seed=2)[2]
    q, kv_b, key, cos, sin = rope_inputs(B, S, segment_positions(B, S, 3),
                                         seed=3)
    q_in = q.clone()

    def forward():
        total, normed = glue.add_rms_norm(x, d, scale, 1e-6)
        _, latent = glue.add_rms_norm(kv[:, :LATENT], None, kv_scale, 1e-6)
        q.copy_(q_in)
        return total, normed, latent, glue.mla_rope(q, kv_b, key, cos, sin)

    graph, out = _captured(forward)
    for seed in (4, 5):
        new_x, new_d, _ = norm_inputs(T, HIDDEN, True, seed=seed)
        x.copy_(new_x)
        d.copy_(new_d)
        kv.copy_(torch.randn(T, LATENT + ROPE, device="cuda"))
        new = rope_inputs(B, S, segment_positions(B, S, seed), seed=seed)
        for static, fresh in zip((q_in, kv_b, key, cos, sin), new):
            static.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        total, normed, latent, k = out
        twin_sum, twin = glue.add_rms_norm_reference(x, d, scale, 1e-6)
        assert torch.equal(total, twin_sum)
        assert ulp_excess(normed, twin, 2) <= 0
        assert ulp_excess(latent, glue.add_rms_norm_reference(
            kv[:, :LATENT], None, kv_scale, 1e-6)[1], 2) <= 0
        q_twin = q_in.clone()
        assert torch.equal(k, glue.mla_rope_reference(q_twin, kv_b, key,
                                                      cos, sin))
        assert torch.equal(q, q_twin)


def test_norm_and_rope_refuse_what_the_kernels_do_not_take(card):
    x, d, scale = norm_inputs(64, HIDDEN, True, seed=0)
    for dtype in (torch.float16, torch.float32):
        with pytest.raises(ValueError, match="x must be bf16"):
            glue.add_rms_norm(x.to(dtype), None, scale, 1e-6)
        with pytest.raises(ValueError, match="delta must be bf16"):
            glue.add_rms_norm(x, d.to(dtype), scale, 1e-6)
    with pytest.raises(ValueError, match="contiguous last axis"):
        glue.add_rms_norm(x.T.contiguous().T, None, scale, 1e-6)
    with pytest.raises(ValueError, match="aligned"):
        glue.add_rms_norm(x.reshape(-1)[1:1 + 63 * HIDDEN].view(63, HIDDEN),
                          None, scale, 1e-6)
    with pytest.raises(ValueError, match="delta must be contiguous"):
        glue.add_rms_norm(x, d.T.contiguous().T, scale, 1e-6)
    with pytest.raises(ValueError, match="share a device"):
        glue.add_rms_norm(x, d, scale.cpu(), 1e-6)
    q, kv_b, key, cos, sin = rope_inputs(2, 8, torch.arange(8).expand(2, 8),
                                         seed=0)
    with pytest.raises(ValueError, match="q must be torch.bfloat16"):
        glue.mla_rope(q.float(), kv_b, key, cos, sin)
    with pytest.raises(ValueError, match="cos must be torch.float32"):
        glue.mla_rope(q, kv_b, key, cos.to(torch.bfloat16), sin)
    with pytest.raises(ValueError, match="contiguous"):
        glue.mla_rope(q.transpose(0, 1).contiguous().transpose(0, 1), kv_b,
                      key, cos, sin)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(2 * 8 * ROPE + 1, dtype=torch.bfloat16,
                           device="cuda")
        glue.mla_rope(q, kv_b, flat[1:].view(2, 8, ROPE), cos, sin)
    with pytest.raises(ValueError, match="share a device"):
        glue.mla_rope(q, kv_b, key, cos.cpu(), sin)


SMALL = {"hidden_size": 256, "num_attention_heads": 4,
         "num_key_value_heads": 4, "qk_nope_head_dim": 128,
         "qk_rope_head_dim": 64, "v_head_dim": 128, "kv_lora_rank": 64,
         "intermediate_size": 512, "moe_intermediate_size": 64,
         "vocab_size": 512, "num_hidden_layers": 3}


def test_small_model_graphed_matches_reference(card, tmp_path):
    """A 3-layer model at the kernels' widths (q/k 192, v 128) through the
    model class on the card: packed and padded keys captured and replayed,
    against the float32 reference layer by layer, cosine > 0.999."""
    from tests.deepseek_v2_checkpoint import TINY, write_checkpoint
    from tests.reference import deepseek_v2 as ref

    from marqo_tpu_torch.inference import loaders
    from marqo_tpu_torch.inference.types import Device
    config = dict(TINY, **SMALL)
    directory = write_checkpoint(str(tmp_path / "small"), c=config)
    model = loaders.load_model("dsv2-card", {
        "type": "hf", "name": "dsv2-card", "localpath": directory,
        "dimensions": 256, "tokens": 512, "pooling_method": "mean"},
        Device.CUDA)
    rng = np.random.default_rng(0)
    texts = ["".join(chr(97 + int(c)) for c in rng.integers(0, 26, n))
             for n in rng.integers(3, 300, 40)]
    first = model.encode(texts)
    before = dict(glue.LAUNCHES)
    again = model.encode(texts)
    single = model.encode(texts[:1])
    assert len(model.graphs.graphs) == 2
    # the replays ran the norm and RoPE passes: per forward 3 L + 1 norms
    # (input, post and latent norms, the final norm) and L RoPE passes
    L = config["num_hidden_layers"]
    norms = glue.LAUNCHES["add_rms_norm"] - before["add_rms_norm"]
    ropes = glue.LAUNCHES["mla_rope"] - before["mla_rope"]
    assert ropes > 0 and ropes % L == 0 and norms * L == ropes * (3 * L + 1)
    np.testing.assert_allclose(first, again, atol=2e-3)
    weights = ref.Weights(directory, "cuda")
    ref.float32_only()
    batch = model.tokenizer.encode_batch(texts)
    with torch.no_grad():
        expected = ref.encode(weights, config,
                              torch.from_numpy(batch["input_ids"]).long(),
                              torch.from_numpy(batch["attention_mask"]).long()
                              ).cpu().numpy()
    cosines = (first * expected).sum(1)
    assert cosines.min() > 0.999, cosines.min()
    assert float((single[0] * expected[0]).sum()) > 0.999


@pytest.mark.parametrize("mode", ["padding", "segment"])
def test_existing_b1_times_hold(card, mode):
    """B1's padding and segment modes at the encoders' (256, 12, 128, 64)
    bf16, contiguous, timed as chip_smoke.py's timing phase (queued, mean of
    two runs of 20): no more than 2% slower than PERF.md's kernel table."""
    q, k, v, pad, seg = attention_inputs(256, 12, 128, 64, torch.bfloat16,
                                         seed=256)
    kernel = {"padding": lambda: fa.attention_padding(q, k, v, pad),
              "segment": lambda: fa.attention_segment(q, k, v, seg)}[mode]
    ms = (queued_ms(kernel, 20) + queued_ms(kernel, 20)) / 2
    print(f"B1 {mode} (256, 12, 128, 64) bf16: {ms:.4f} ms "
          f"(table {KERNEL_TABLE_MS[mode]}) on "
          f"{torch.cuda.get_device_name(0)}")
    assert ms <= 1.02 * KERNEL_TABLE_MS[mode], ms
