"""DeepSeek-V2's kernels and model on the card: B1's causal modes at the
latent attention's widths (q/k 192, v 128) against their twin, the
grouped expert GEMM against its twin at the bulk-ingest cell's token
counts, a small model at the kernels' widths through the graphed path
against the float32 reference, and B1's existing padding and segment
times at the encoders' shape against PERF.md's kernel table. Skips
without an sm_90 CUDA device and nvcc; on a Hopper host run

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_deepseek_v2_cuda.py

Tolerances: attention as chip_smoke.py's ``check_attention`` (fp32 |err|
<= 1e-5; bf16 |err| <= 4e-3 + 1e-2 |ref|, which the twin with a softmax
scale off by 10% must fail); the grouped GEMM's bf16 output against the
twin's (cuBLAS per group, another summation order): 1e-2 of the output's
largest magnitude, which a group's rows through another group's weight
must fail.
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import (DSV2_SCALE, SCALE_CONTROL, attention_excess,
                        attention_inputs, check_attention, mla_inputs,
                        queued_ms)
from marqo_tpu_torch.ops import _build
from marqo_tpu_torch.ops import flash_attention as fa
from marqo_tpu_torch.ops import moe

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
    out = moe.expert_layer(*(t.cuda() for t in (x, valid, router, gate_up,
                                                down)), 6, counts=counts)
    twin = moe.expert_layer(x, valid, router, gate_up, down, 6)
    torch.cuda.synchronize()
    assert int(counts.sum()) == 6 * (T - 100)
    scale = float(twin.float().abs().max())
    err = float((out.cpu().float() - twin.float()).abs().max())
    assert err <= 2e-2 * scale, (err, scale)
    assert not out[-100:].any()


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
    again = model.encode(texts)
    single = model.encode(texts[:1])
    assert len(model.graphs.graphs) == 2
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
