"""DeepSeek-V2 as a mean-pooled text embedder (models/deepseek_v2.py,
ops/moe.py, B1's causal modes), on the CPU at a tiny ``deepseek_v2``
config with YaRN on and seeded random weights:

- the plain reference (tests/reference/deepseek_v2.py) against
  transformers' ``DeepseekV2Model``, mean-pooled: the reference held to the
  published equations;
- the port's eager forward, padded and packed, against the reference;
- B1's causal twin against a plain masked softmax at Dqk != Dv;
- the expert layer against a per-token loop;
- the norm and RoPE passes' twins and the reshaped layers against today's
  composition, bit for bit, and the inputs their kernels refuse;
- a stand-in CUDA graph of one key, replayed bit for bit, and the
  ``moe.expert_tokens`` counter;
- the ``hf`` type's dispatch, sharded loading, and the HTTP API end to end.
"""

import filecmp
import json
import math
import os

import numpy as np
import pytest
import torch

from marqo_tpu_torch.inference import batching, graphs, loaders
from marqo_tpu_torch.inference.types import Device
from marqo_tpu_torch.models import deepseek_v2 as dsv2
from marqo_tpu_torch.ops import decoder_glue as glue
from marqo_tpu_torch.ops import flash_attention as fa
from marqo_tpu_torch.ops import moe
from marqo_tpu_torch.ops.packing import pack_sequences
from tests.deepseek_v2_checkpoint import (TINY, state_dict,
                                          write_checkpoint)
from tests.reference import deepseek_v2 as ref
from tests.test_torch_encoder_graphs import StandIn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def load(sd: dict, dtype=torch.float32):
    """The port's model of ``sd`` on the CPU, read tensor by tensor."""
    model = dsv2.empty_model(dsv2.config_from_hf(TINY), dtype, "cpu")
    return dsv2.load_tensors(model, ((name, (lambda t=t: t))
                                     for name, t in sd.items()))


def port_model(sd: dict = None, dtype=torch.float32):
    return load(state_dict() if sd is None else sd, dtype)


def rows(seed: int = 1, lengths=(9, 17, 3, 12)):
    """Right-padded (B, S) ids and mask of sequences of ``lengths``."""
    rng = np.random.default_rng(seed)
    S = max(lengths)
    ids = np.zeros((len(lengths), S), dtype=np.int64)
    mask = np.zeros((len(lengths), S), dtype=np.int64)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(0, TINY["vocab_size"], n)
        mask[i, :n] = 1
    return torch.from_numpy(ids), torch.from_numpy(mask)


def reference_vectors(tmp_path, ids, mask, sd=None):
    directory = write_checkpoint(str(tmp_path / "ref"), sd)
    weights = ref.Weights(directory, "cpu")
    with torch.no_grad():
        return ref.encode(weights, ref.read_config(directory), ids, mask)


def cosine(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return (torch.nn.functional.normalize(a, dim=-1) *
            torch.nn.functional.normalize(b, dim=-1)).sum(-1)


# --- the reference held to transformers -----------------------------------------

def test_reference_matches_transformers_deepseek_v2(tmp_path):
    from transformers import DeepseekV2Config, DeepseekV2Model
    sd = state_dict()
    config = DeepseekV2Config(**{k: v for k, v in TINY.items()
                                 if k not in ("model_type", "architectures")})
    config._attn_implementation = "eager"
    model = DeepseekV2Model(config).eval()
    missing, unexpected = model.load_state_dict(
        {k[len("model."):]: v for k, v in sd.items()
         if k.startswith("model.")}, strict=False)
    assert not missing and not unexpected
    # transformers' DeepseekV2Attention leaves out DeepSeek's mscale^2 on
    # the softmax scale (the reference's first noted departure)
    _, _, scale = ref.yarn(TINY)
    for layer in model.layers:
        layer.self_attn.scaling = scale
    ids, mask = rows()
    with torch.no_grad():
        hidden = model(input_ids=ids, attention_mask=mask).last_hidden_state
    m = mask.float()[..., None]
    expected = torch.nn.functional.normalize((hidden * m).sum(1) / m.sum(1),
                                             dim=-1)
    got = reference_vectors(tmp_path, ids, mask, sd)
    torch.testing.assert_close(got, expected, atol=2e-6, rtol=0)
    assert scale == pytest.approx((0.1 * 0.707 * math.log(40) + 1) ** 2 /
                                  math.sqrt(24))
    # the scale matters: transformers' own gives vectors the tolerance sees
    for layer in model.layers:
        layer.self_attn.scaling = 24 ** -0.5
    with torch.no_grad():
        hidden = model(input_ids=ids, attention_mask=mask).last_hidden_state
    plain = torch.nn.functional.normalize((hidden * m).sum(1) / m.sum(1),
                                          dim=-1)
    assert float((plain - got).abs().max()) > 1e-3


# --- the port held to the reference ----------------------------------------------

@pytest.mark.parametrize("path", ["padded", "packed"])
def test_port_matches_reference(tmp_path, path):
    ids, mask = rows()
    expected = reference_vectors(tmp_path, ids, mask)
    model = port_model()
    with torch.inference_mode():
        if path == "padded":
            got = dsv2.encode_tokens(model, ids, mask)
        else:
            lengths = mask.sum(1).tolist()
            packed = pack_sequences([ids[i, :n].tolist()
                                     for i, n in enumerate(lengths)],
                                    seq_len=32, row_buckets=[2, 4])
            got = dsv2.encode_tokens_packed(
                model, *(torch.from_numpy(a) for a in (
                    packed.input_ids, packed.segment_ids, packed.positions,
                    packed.seq_index)), len(lengths))
    assert float(cosine(got, expected).min()) > 1 - 1e-5


def test_packed_matches_padded():
    ids, mask = rows(seed=3, lengths=(5, 20, 11, 1, 14, 8))
    model = port_model()
    lengths = mask.sum(1).tolist()
    packed = pack_sequences([ids[i, :n].tolist()
                             for i, n in enumerate(lengths)],
                            seq_len=32, row_buckets=[4])
    with torch.inference_mode():
        padded = dsv2.encode_tokens(model, ids, mask)
        got = dsv2.encode_tokens_packed(
            model, *(torch.from_numpy(a) for a in (
                packed.input_ids, packed.segment_ids, packed.positions,
                packed.seq_index)), len(lengths))
    torch.testing.assert_close(got, padded, atol=2e-5, rtol=0)


def test_bf16_port_is_near_the_reference(tmp_path):
    """The served dtype on the CPU: bf16 stays close, and a wrong softmax
    scale does not."""
    ids, mask = rows(seed=5)
    expected = reference_vectors(tmp_path, ids, mask)
    with torch.inference_mode():
        got = dsv2.encode_tokens(port_model(dtype=torch.bfloat16), ids, mask)
    assert float(cosine(got, expected).min()) > 0.999


# --- B1's causal modes ------------------------------------------------------------

def plain_causal(q, k, v, allowed_key, scale):
    """A loop over rows and queries: softmax over the allowed keys j <= i
    (a row with none: the uniform mean of V over every key)."""
    B, N, S, _ = q.shape
    out = torch.empty(B, N, S, v.shape[-1])
    for b in range(B):
        for i in range(S):
            keys = [j for j in range(i + 1) if allowed_key(b, i, j)]
            if not keys:
                out[b, :, i] = v[b].float().mean(1)
                continue
            s = (q[b, :, i:i + 1].float() @ k[b, :, keys].float()
                 .transpose(-1, -2)) * scale
            out[b, :, i] = (torch.softmax(s, -1) @ v[b, :, keys].float())[:, 0]
    return out


@pytest.mark.parametrize("mode", ["padding", "segment"])
def test_causal_twin_matches_a_plain_masked_softmax(mode):
    g = torch.Generator().manual_seed(7)
    B, N, S = 3, 2, 11
    q = torch.randn(B, N, S, 24, generator=g)
    k = torch.randn(B, N, S, 24, generator=g)
    v = torch.randn(B, N, S, 16, generator=g)
    scale = 0.3
    if mode == "padding":
        lengths = [11, 6, 1]
        mask = torch.tensor([[1] * n + [0] * (S - n) for n in lengths])
        got = fa.attention_padding(q, k, v, mask, causal=True, scale=scale)

        def allowed(b, i, j):
            return mask[b, j] > 0
    else:
        mask = torch.tensor([[1, 1, 1, 2, 2, 3, 3, 3, 3, 0, 0],
                             [1] * 11,
                             [1, 2, 3, 4, 5, 6, 7, 0, 0, 0, 0]])
        got = fa.attention_segment(q, k, v, mask, causal=True, scale=scale)

        def allowed(b, i, j):
            return mask[b, j] > 0 and mask[b, j] == mask[b, i]
    assert got.shape == (B, N, S, 16)
    expected = plain_causal(q, k, v, allowed, scale)
    torch.testing.assert_close(got, expected, atol=1e-5, rtol=0)


def test_causal_launch_refuses_other_head_dims():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="causal modes take"):
        fa._launch_causal(q, q, q, torch.ones(1, 8), "padding")


# --- the expert layer -------------------------------------------------------------

def per_token_experts(x, valid, router, gate_up, down, top_k):
    """Each token on its own: softmax over the routed experts, its top k
    weighted."""
    F = down.shape[2]
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        if not valid[t]:
            continue
        probs = torch.softmax(x[t].float() @ router.float().T, -1)
        weights, chosen = torch.topk(probs, top_k)
        for e, w in zip(chosen.tolist(), weights.tolist()):
            h = gate_up[e] @ x[t]
            y = down[e] @ (torch.nn.functional.silu(h[:F]) * h[F:])
            out[t] += w * y
    return out


def test_expert_layer_matches_a_per_token_loop():
    g = torch.Generator().manual_seed(11)
    T, H, F, E, k = 40, 16, 8, 6, 2
    x = torch.randn(T, H, generator=g)
    x[:, 0] = 1.0
    router = torch.randn(E, H, generator=g)
    router[3] = 0.0
    router[3, 0] = -50.0  # expert 3: no token
    gate_up = torch.randn(E, 2 * F, H, generator=g) * 0.3
    down = torch.randn(E, H, F, generator=g) * 0.3
    valid = torch.ones(T, dtype=torch.bool)
    valid[[5, 17, 39]] = False
    counts = torch.zeros(E, dtype=torch.int64)
    got = moe.expert_layer(x, valid, router, gate_up, down, k, counts=counts)
    expected = per_token_experts(x, valid, router, gate_up, down, k)
    torch.testing.assert_close(got, expected, atol=1e-5, rtol=0)
    assert counts[3] == 0
    assert int(counts.sum()) == int(valid.sum()) * k
    assert not got[~valid].any()


def todays_expert_layer(x, valid, router, gate_up, down, top_k):
    """The expert layer as it was composed before the SwiGLU and combine
    passes: SiLU and multiply on the gate/up halves, the rows gathered back
    into token order, a batched GEMV with bf16-rounded weights, pad tokens
    zeroed afterwards."""
    T, H = x.shape
    E = router.shape[0]
    weights, experts = moe.route(x, router, top_k)
    groups = torch.where(valid[:, None], experts, E).reshape(-1)
    sizes = torch.zeros(E + 1, dtype=torch.int32)
    sizes.index_add_(0, groups, torch.ones_like(groups, dtype=torch.int32))
    offsets = torch.cumsum(sizes[:E], 0, dtype=torch.int32)
    order = torch.argsort(groups, stable=True)
    h = moe.grouped_mm(x[order // top_k], gate_up, offsets)
    gate, up = h.chunk(2, dim=-1)
    act = torch.nn.functional.silu(gate).mul_(up)
    y = moe.grouped_mm(act, down, offsets)
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel())
    y = y[back].view(T, top_k, H)
    out = torch.bmm(weights.to(y.dtype)[:, None, :], y).view(T, H)
    return torch.where(valid[:, None], out, out.new_zeros(()))


def expert_inputs(T, k, pad, dtype, seed=13, H=16, F=8, E=6):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, H, generator=g).to(dtype)
    router = torch.randn(E, H, generator=g).to(dtype)
    gate_up = (torch.randn(E, 2 * F, H, generator=g) * 0.3).to(dtype)
    down = (torch.randn(E, H, F, generator=g) * 0.3).to(dtype)
    valid = torch.ones(T, dtype=torch.bool)
    if pad:
        valid[torch.randperm(T, generator=g)[:max(1, T // 4)]] = False
    return x, valid, router, gate_up, down


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,k,pad", [(37, 2, True), (37, 2, False),
                                     (37, 6, True), (37, 6, False),
                                     (1, 2, False), (1, 6, False),
                                     (1, 6, True)])
def test_expert_layer_twins_match_todays_composition(T, k, pad, dtype):
    """The CPU path (the SwiGLU and combine twins) computes exactly what
    the layer computed before them, pad tokens 0."""
    x, valid, router, gate_up, down = expert_inputs(T, k, pad, dtype)
    counts = torch.zeros(router.shape[0], dtype=torch.int64)
    before = dict(moe.LAUNCHES)
    got = moe.expert_layer(x, valid, router, gate_up, down, k, counts=counts)
    assert torch.equal(got, todays_expert_layer(x, valid, router, gate_up,
                                                down, k))
    assert got.dtype == dtype and got.shape == x.shape
    assert not got[~valid].any()
    assert int(counts.sum()) == int(valid.sum()) * k
    assert moe.LAUNCHES == before  # the twins launch nothing


def fused_swiglu(h):
    """What the card's pass computes: silu(gate) * up in fp32, rounded
    once."""
    gate, up = h.float().chunk(2, dim=-1)
    return (torch.nn.functional.silu(gate) * up).to(h.dtype)


@pytest.mark.parametrize("rows", [1, 5])
@pytest.mark.parametrize("W", [1408, 2816, 10944])
def test_swiglu_twin_matches_todays_composition(W, rows):
    """The routed width (1,408) and the dense ones (the shared experts'
    2,816, layer 0's 10,944): the twin is today's SiLU-then-multiply, and
    within one bf16 rounding of the pass's single rounding."""
    g = torch.Generator().manual_seed(W + rows)
    h = (torch.randn(rows, 2 * W, generator=g) * 3).to(torch.bfloat16)
    gate, up = h.chunk(2, dim=-1)
    got = moe.swiglu(h)
    assert got.shape == (rows, W) and got.dtype == torch.bfloat16
    assert torch.equal(got, torch.nn.functional.silu(gate) * up)
    once = fused_swiglu(h).float()
    assert float(((got.float() - once).abs() - 2 ** -7 * once.abs()).max()) \
        <= 1e-30
    # the count changes nothing on the CPU: the twin computes every row
    assert torch.equal(moe.swiglu(h, torch.tensor([0], dtype=torch.int32)),
                       got)


@pytest.mark.parametrize("width", [2816, 10944])
@pytest.mark.parametrize("T", [1, 9])
def test_dense_mlp_matches_todays_composition(width, T):
    g = torch.Generator().manual_seed(width + T)
    mlp = dsv2.DenseMLP(16, width).to(torch.bfloat16)
    with torch.no_grad():
        for p in mlp.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        x = torch.randn(1, T, 16, generator=g).to(torch.bfloat16)
        gate, up = mlp.gate_up(x).chunk(2, dim=-1)
        expected = mlp.down(torch.nn.functional.silu(gate) * up)
        assert torch.equal(mlp(x), expected)


@pytest.mark.parametrize("k", [2, 6])
@pytest.mark.parametrize("pad", [True, False])
def test_combine_twin_reads_back_a_permutation_and_zeroes_pad_tokens(k, pad):
    """``back_rows`` inverts the sort into expert order; the combine twin
    is today's gather and weighted sum; a pad token comes out 0 even where
    its rows hold NaN (rows past the last group are undefined)."""
    T, H, E = 23, 16, 5
    g = torch.Generator().manual_seed(k)
    valid = torch.ones(T, dtype=torch.bool)
    if pad:
        valid[[0, 7, 22]] = False
    experts = torch.randint(0, E, (T, k), generator=g)
    groups = torch.where(valid[:, None], experts, E).reshape(-1)
    order = torch.argsort(groups, stable=True)
    back = moe.back_rows(order)
    assert back.dtype == torch.int32
    assert torch.equal(back.sort().values, torch.arange(T * k,
                                                        dtype=torch.int32))
    assert torch.equal(order[back.long()], torch.arange(T * k))
    # a token's rows come before every pad token's
    real = int(valid.sum()) * k
    assert int(back.view(T, k)[valid].max()) < real
    y = torch.randn(T * k, H, generator=g).to(torch.bfloat16)
    y[real:] = float("nan")
    weights = torch.rand(T, k, generator=g)
    got = moe.combine(y, back.view(T, k), weights, valid)
    assert got.shape == (T, H) and got.dtype == torch.bfloat16
    assert not got[~valid].any() and bool(torch.isfinite(got).all())
    rows = y[back.long()].view(T, k, H)
    expected = torch.bmm(weights.to(torch.bfloat16)[:, None, :],
                         rows).view(T, H)
    assert torch.equal(got[valid], expected[valid])
    # within bf16 roundings (the weights', the CPU's bf16 sums', the
    # output's) of the exact fp32-weighted sum: 2^-6 of the terms'
    # magnitudes
    terms = weights[..., None] * rows.float()
    err = (got.float() - terms.sum(1))[valid].abs()
    assert float((err - 2 ** -6 * terms.abs().sum(1)[valid]).max()) <= 0


def _swiglu_h(dtype=torch.bfloat16):
    return torch.zeros(4, 32, dtype=dtype)


@pytest.mark.parametrize("case,match", [
    (lambda: (_swiglu_h(dtype=torch.float16), None), "must be bf16"),
    (lambda: (_swiglu_h(dtype=torch.float32), None), "must be bf16"),
    (lambda: (_swiglu_h().T.contiguous().T, None), "contiguous"),
    (lambda: (torch.zeros(4, 24, dtype=torch.bfloat16), None), "multiple"),
    (lambda: (_swiglu_h()[:0], None), "rows"),
    (lambda: (_swiglu_h(), torch.zeros(1, dtype=torch.int64)), "int32"),
    (lambda: (_swiglu_h(), torch.zeros(2, dtype=torch.int32)), "one int32"),
])
def test_swiglu_refuses_what_the_kernel_does_not_take(case, match):
    h, count = case()
    with pytest.raises(ValueError, match=match):
        moe.check_swiglu_inputs(h, count)


def _combine_args(T=3, k=2, H=16, **change):
    args = {"y": torch.zeros(T * k, H, dtype=torch.bfloat16),
            "back": torch.zeros(T, k, dtype=torch.int32),
            "weights": torch.zeros(T, k),
            "valid": torch.ones(T, dtype=torch.bool)}
    args.update(change)
    return args


@pytest.mark.parametrize("change,match", [
    ({"y": torch.zeros(6, 16, dtype=torch.float16)}, "must be bf16"),
    ({"y": torch.zeros(6, 16)}, "must be bf16"),
    # k past the rows a token keeps in flight (csrc/moe_glue.cu kMaxTopK)
    ({"back": torch.zeros(3, 9, dtype=torch.int32)}, "k <= 8"),
    ({"y": torch.zeros(16, 6, dtype=torch.bfloat16).T}, "contiguous"),
    ({"y": torch.zeros(6, 12, dtype=torch.bfloat16)}, "multiple"),
    ({"back": torch.zeros(3, 2, dtype=torch.int64)}, "back must be"),
    ({"weights": torch.zeros(3, 2, dtype=torch.bfloat16)}, "weights must"),
    ({"valid": torch.ones(3, dtype=torch.int32)}, "valid must"),
    ({"weights": torch.zeros(2, 3).T}, "contiguous"),
])
def test_combine_refuses_what_the_kernel_does_not_take(change, match):
    with pytest.raises(ValueError, match=match):
        moe.check_combine_inputs(**_combine_args(**change))


def test_kernel_inputs_pass_the_checks():
    moe.check_swiglu_inputs(torch.zeros(3, 4, 32, dtype=torch.bfloat16),
                            torch.zeros(1, dtype=torch.int32))
    moe.check_swiglu_inputs(torch.zeros(1, 16, dtype=torch.bfloat16))
    moe.check_combine_inputs(**_combine_args())
    moe.check_combine_inputs(**_combine_args(T=1, k=moe.MAX_TOP_K, H=8))
    # the norm: the residual stream, the latent read in place from kv_a's
    # (B, S, 576) output, one row, the widest row
    x = torch.zeros(2, 5, 64, dtype=torch.bfloat16)
    glue.check_add_rms_norm_inputs(x, torch.zeros_like(x), _scale(64))
    kv = torch.zeros(2, 5, 72, dtype=torch.bfloat16)
    glue.check_add_rms_norm_inputs(kv[..., :64], None, _scale(64))
    glue.check_add_rms_norm_inputs(torch.zeros(8, dtype=torch.bfloat16), None,
                                   _scale(8))
    glue.check_add_rms_norm_inputs(
        torch.zeros(1, glue.MAX_WIDTH, dtype=torch.bfloat16), None,
        _scale(glue.MAX_WIDTH))
    glue.check_mla_rope_inputs(**_rope_args())
    glue.check_mla_rope_inputs(**_rope_args(nope=0))
    glue.check_mla_rope_inputs(**_rope_args(rope=glue.MAX_ROPE))


def test_grouped_mm_twin_skips_rows_past_the_last_group():
    rows_ = torch.arange(12.0).view(6, 2)
    weight = torch.stack([torch.eye(2), 2 * torch.eye(2), 3 * torch.eye(2)])
    out = moe.grouped_mm_reference(rows_, weight,
                                   torch.tensor([2, 2, 5], dtype=torch.int32))
    torch.testing.assert_close(out[:2], rows_[:2])
    torch.testing.assert_close(out[2:5], 3 * rows_[2:5])
    assert not out[5].any()


# --- the norm and RoPE passes ------------------------------------------------------

def float64_rms_norm(x, scale, eps):
    """RMSNorm from its definition in float64: scale x / sqrt(mean x^2 +
    eps)."""
    x64 = x.double()
    return scale.double() * x64 / torch.sqrt(
        x64.pow(2).mean(-1, keepdim=True) + eps)


def float64_rotate(x, cos, sin):
    """Each interleaved pair (a, b) of x as a + ib times cos + i sin, in
    float64."""
    pairs = torch.view_as_complex(x.double().reshape(*x.shape[:-1], -1, 2)
                                  .contiguous())
    turned = pairs * torch.complex(cos.double(), sin.double())
    return torch.view_as_real(turned).flatten(-2)


# the twins' two roundings of a bf16 value (the normalised row, then the
# scaled one), and fp32's for float32
ROUNDING = {torch.bfloat16: 2 ** -7, torch.float32: 2 ** -20}


def todays_attention(attn, x, c, rope, attend):
    """``Attention.forward`` before the passes: the latent norm, then k
    assembled by two strided copies and q's RoPE part rotated in place."""
    B, S, _ = x.shape
    N, nope, rd = c.num_heads, c.qk_nope_head_dim, c.qk_rope_head_dim
    q = attn.q_proj(x).view(B, S, N, nope + rd)
    kv = attn.kv_a(x)
    latent = glue.rms_norm(kv[..., :c.kv_lora_rank], attn.kv_a_norm,
                           c.rms_norm_eps)
    kv_b = attn.kv_b(latent).view(B, S, N, nope + c.v_head_dim)
    k = torch.empty_like(q)
    k[..., :nope] = kv_b[..., :nope]
    k[..., nope:] = glue.rotate(kv[..., None, c.kv_lora_rank:], *rope)
    q[..., nope:] = glue.rotate(q[..., nope:], *rope)
    ctx = attend(q.transpose(1, 2), k.transpose(1, 2),
                 kv_b[..., nope:].transpose(1, 2))
    return attn.o_proj(ctx.transpose(1, 2).reshape(B, S, -1))


def todays_hidden(model, input_ids, positions, valid, attend):
    """``DeepseekV2Encoder.hidden`` before the passes: each residual add a
    pass of its own, then the next norm."""
    c = model.config
    eps = c.rms_norm_eps
    x = model.embed(input_ids.long())
    rope = dsv2.rope_tables(positions, c)
    for layer in model.layers:
        x = x + todays_attention(layer.attn,
                                 glue.rms_norm(x, layer.input_norm, eps),
                                 c, rope, attend)
        x = x + layer.mlp(glue.rms_norm(x, layer.post_norm, eps), valid)
    return glue.rms_norm(x, model.norm, eps)


def _scale(W, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (1 + 0.1 * torch.randn(W, generator=g)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W,rows_,stride", [(2048, 7, None), (512, 9, 576),
                                            (16, 1, None), (64, 5, 72)])
@pytest.mark.parametrize("with_delta,keep_sum", [(True, True), (True, False),
                                                 (False, True)])
def test_add_rms_norm_twin_matches_todays_composition(
        dtype, W, rows_, stride, with_delta, keep_sum):
    """The twin is ``x + delta`` then the model's RMSNorm (``rms_norm``),
    bit for bit, and within its two roundings of RMSNorm's definition in
    float64; x may be the latent's slice of a wider row (read in place);
    without delta the stream comes back as it was, itself."""
    g = torch.Generator().manual_seed(W + rows_)
    wide = (3 * torch.randn(2, rows_, stride or W, generator=g)).to(dtype)
    x = wide[..., :W]
    if stride is None:
        assert x.is_contiguous()
    delta = torch.randn(2, rows_, W, generator=g).to(dtype) \
        if with_delta else None
    scale = _scale(W, dtype, seed=W)
    before = dict(glue.LAUNCHES)
    total, normed = glue.add_rms_norm(x, delta, scale, 1e-6, keep_sum)
    s = x if delta is None else x + delta
    assert torch.equal(normed, glue.rms_norm(s, scale, 1e-6))
    torch.testing.assert_close(normed.double(),
                               float64_rms_norm(s, scale, 1e-6),
                               rtol=ROUNDING[dtype], atol=1e-30)
    assert normed.dtype == dtype and normed.shape == x.shape
    if keep_sum:
        assert torch.equal(total, s)
        if delta is None:
            assert total is x
    else:
        assert total is None
    assert glue.LAUNCHES == before  # the twin launches nothing


def _rope_args(B=2, S=6, N=3, nope=16, rope=8, v=24, dtype=torch.bfloat16,
               positions=None, seed=0, **change):
    """q, kv_b, the RoPE key as a slice of kv_a's output (latent 32 wide)
    and the tables of ``positions`` (B, S) (default arange(S))."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, N, nope + rope, generator=g).to(dtype)
    kv_b = torch.randn(B, S, N, nope + v, generator=g).to(dtype)
    kv = torch.randn(B, S, 32 + rope, generator=g).to(dtype)
    c = dsv2.DeepseekV2Config(qk_rope_head_dim=rope, qk_nope_head_dim=nope,
                              rope_scaling=(("factor", 4.0), (
                                  "original_max_position_embeddings", 8),
                                  ("mscale", 0.707),
                                  ("mscale_all_dim", 0.707)))
    if positions is None:
        positions = torch.arange(S).expand(B, S)
    cos, sin = dsv2.rope_tables(positions, c)
    args = {"q": q, "kv_b": kv_b, "key": kv[..., 32:], "cos": cos,
            "sin": sin}
    args.update(change)
    return args


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["packed", "padded"])
@pytest.mark.parametrize("B,S,N,nope,rope,v", [(2, 11, 3, 16, 8, 24),
                                               (1, 5, 16, 128, 64, 128)])
def test_mla_rope_twin_matches_todays_assembly(dtype, layout, B, S, N, nope,
                                               rope, v):
    """The twin is the model's two strided copies into k and q's rotation
    in place (``rotate``), bit for bit, and within a rounding of each pair
    turned as a complex number in float64, at packed positions that
    restart per segment and at the padded path's arange(S); k's RoPE part
    is the one shared key."""
    positions = None
    if layout == "packed":
        positions = torch.tensor([[0, 1, 2, 0, 1, 2, 3, 4, 0, 0, 1][:S]] * B)
    args = _rope_args(B, S, N, nope, rope, v, dtype, positions, seed=S)
    q0 = args["q"].clone()
    before = dict(glue.LAUNCHES)
    k = glue.mla_rope(**args)
    cos, sin = args["cos"], args["sin"]
    expected_k = torch.empty_like(q0)
    expected_k[..., :nope] = args["kv_b"][..., :nope]
    expected_k[..., nope:] = glue.rotate(args["key"][..., None, :], cos, sin)
    expected_q = q0.clone()
    expected_q[..., nope:] = glue.rotate(q0[..., nope:], cos, sin)
    assert torch.equal(k, expected_k) and torch.equal(args["q"], expected_q)
    for got, x in ((k[..., nope:], args["key"][..., None, :]),
                   (args["q"][..., nope:], q0[..., nope:])):
        turned = float64_rotate(x, cos, sin).expand_as(got)
        torch.testing.assert_close(
            got.double(), turned, rtol=ROUNDING[dtype],
            atol=ROUNDING[dtype] * float(x.double().abs().max()))
    assert k.dtype == dtype and k.shape == q0.shape
    assert torch.equal(k[..., nope:], k[..., :1, nope:].expand_as(
        k[..., nope:]))
    assert torch.equal(args["q"][..., :nope], q0[..., :nope])
    assert glue.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path", ["padded", "packed"])
def test_reshaped_layers_give_todays_hidden_states(dtype, path):
    """``DecoderLayer`` and ``hidden`` with each residual add folded into
    the next norm give the hidden states the model gave before, bit for
    bit, on both paths and in both dtypes."""
    model = port_model(dtype=dtype)
    c = model.config
    scale = dsv2.yarn(c)[2]
    ids, mask = rows(seed=9, lengths=(5, 20, 11, 1, 14, 8))
    if path == "padded":
        positions = torch.arange(ids.shape[1]).expand(ids.shape)
        valid = mask > 0

        def attend(q, k, v):
            return fa.attention_padding(q, k, v, mask, causal=True,
                                        scale=scale)
    else:
        lengths = mask.sum(1).tolist()
        packed = pack_sequences([ids[i, :n].tolist()
                                 for i, n in enumerate(lengths)],
                                seq_len=32, row_buckets=[4])
        ids, segments, positions = (torch.from_numpy(a) for a in (
            packed.input_ids, packed.segment_ids, packed.positions))
        valid = segments > 0

        def attend(q, k, v):
            return fa.attention_segment(q, k, v, segments, causal=True,
                                        scale=scale)
    with torch.inference_mode():
        got = model.hidden(ids, positions, valid, attend)
        expected = todays_hidden(model, ids, positions, valid, attend)
    assert got.dtype == dtype and torch.equal(got, expected)


def _norm_case(x=None, delta=None, scale=None, W=16):
    x = torch.zeros(3, W, dtype=torch.bfloat16) if x is None else x
    return x, delta, _scale(W) if scale is None else scale


@pytest.mark.parametrize("case,match", [
    (lambda: _norm_case(torch.zeros(3, 16)), "x must be bf16"),
    (lambda: _norm_case(torch.zeros(3, 16, dtype=torch.float16)),
     "x must be bf16"),
    (lambda: _norm_case(torch.zeros(3, 12, dtype=torch.bfloat16), W=12),
     "multiple"),
    (lambda: _norm_case(torch.zeros(0, 16, dtype=torch.bfloat16)), "rows"),
    (lambda: _norm_case(torch.zeros(1, glue.MAX_WIDTH + 8,
                                    dtype=torch.bfloat16),
                        W=glue.MAX_WIDTH + 8), "up to"),
    (lambda: _norm_case(torch.zeros(16, 3, dtype=torch.bfloat16).T),
     "contiguous last axis"),
    # rows 20 values apart: not a multiple of 8
    (lambda: _norm_case(torch.zeros(3, 20, dtype=torch.bfloat16)[:, :16]),
     "evenly strided"),
    # leading axes that do not collapse into evenly strided rows
    (lambda: _norm_case(torch.zeros(4, 3, 16, dtype=torch.bfloat16)
                        .transpose(0, 1)), "evenly strided"),
    (lambda: _norm_case(torch.zeros(3 * 16 + 1, dtype=torch.bfloat16)[1:]
                        .view(3, 16)), "aligned"),
    (lambda: _norm_case(delta=torch.zeros(3, 16)), "delta must be bf16"),
    (lambda: _norm_case(delta=torch.zeros(3, 8, dtype=torch.bfloat16)),
     "delta must be"),
    (lambda: _norm_case(delta=torch.zeros(16, 3, dtype=torch.bfloat16).T),
     "delta must be contiguous"),
    (lambda: _norm_case(scale=torch.zeros(16)), "scale must be bf16"),
    (lambda: _norm_case(scale=torch.zeros(8, dtype=torch.bfloat16)),
     "scale must be"),
    (lambda: _norm_case(scale=torch.zeros(17, dtype=torch.bfloat16)[1:]),
     "scale must be contiguous and 16-byte aligned"),
])
def test_add_rms_norm_refuses_what_the_kernel_does_not_take(case, match):
    with pytest.raises(ValueError, match=match):
        glue.check_add_rms_norm_inputs(*case())


@pytest.mark.parametrize("change,match", [
    ({"dtype": torch.float32}, "q must be torch.bfloat16"),
    ({"dtype": torch.float16}, "q must be torch.bfloat16"),
    ({"cos": torch.zeros(2, 6, 1, 4, dtype=torch.bfloat16)},
     "cos must be torch.float32"),
    ({"kv_b": torch.zeros(2, 6, 4, 40, dtype=torch.bfloat16)},
     "kv_b's shape"),
    ({"key": torch.zeros(2, 5, 8, dtype=torch.bfloat16)}, "key's shape"),
    ({"sin": torch.zeros(2, 6, 4)}, "sin's shape"),
    ({"nope": 12, "v": 28}, "multiples"),
    ({"rope": 4}, "rope >= 8"),
    ({"rope": 136}, "<= 128"),
    ({"kv_b": torch.zeros(2, 6, 3, 8, dtype=torch.bfloat16)},
     "width >= nope"),
    ({"key": torch.zeros(2, 6, 12, dtype=torch.bfloat16)[..., 4:]},
     "evenly strided"),
    ({"q": torch.zeros(2, 6, 24, 3, dtype=torch.bfloat16).transpose(2, 3)},
     "contiguous"),
    ({"cos": torch.zeros(6, 2, 1, 4).permute(1, 0, 2, 3)}, "contiguous"),
    ({"key": torch.zeros(2 * 6 * 8 + 1, dtype=torch.bfloat16)[1:]
      .view(2, 6, 8)}, "aligned"),
])
def test_mla_rope_refuses_what_the_kernel_does_not_take(change, match):
    args = _rope_args(**{k: v for k, v in change.items()
                         if k in ("dtype", "nope", "rope", "v")})
    args.update({k: v for k, v in change.items()
                 if k not in ("dtype", "nope", "rope", "v")})
    with pytest.raises(ValueError, match=match):
        glue.check_mla_rope_inputs(**args)


# --- the model class: dispatch, loading, graphs, counters ---------------------------

def _props(directory):
    return {"type": "hf", "localpath": directory, "dimensions": 64,
            "tokens": 64, "pooling_method": "mean"}


def test_hf_type_dispatches_on_the_checkpoints_model_type(tmp_path):
    bert = tmp_path / "bert"
    bert.mkdir()
    (bert / "config.json").write_text(json.dumps({"model_type": "bert"}))
    decoder = write_checkpoint(str(tmp_path / "dsv2"))
    assert loaders.resolve_model_class(
        "m", {"type": "hf", "localpath": str(bert)}) is \
        loaders.TorchHFTextModel
    assert loaders.resolve_model_class("m", {"type": "hf"}) is \
        loaders.TorchHFTextModel
    assert loaders.resolve_model_class("m", _props(decoder)) is \
        loaders.TorchDeepseekV2Model


def test_sharded_checkpoint_loads_the_same_tensors(tmp_path):
    sd = state_dict()
    config = dsv2.config_from_hf(TINY)
    models = []
    for shards in (0, 3):
        directory = write_checkpoint(str(tmp_path / f"s{shards}"), sd, shards)
        models.append(dsv2.load_tensors(
            dsv2.empty_model(config, torch.float32, "cpu"),
            loaders.checkpoint_tensors(directory)))
    whole, sharded = (dict(m.named_parameters()) for m in models)
    assert whole.keys() == sharded.keys()
    for name in whole:
        assert torch.equal(whole[name], sharded[name]), name
    # and what they hold is the state dict
    expected = port_model(sd)
    for name, tensor in expected.named_parameters():
        assert torch.equal(whole[name], tensor), name


def test_missing_tensor_is_an_error(tmp_path):
    sd = state_dict()
    del sd["model.layers.2.mlp.experts.5.up_proj.weight"]
    with pytest.raises(KeyError, match="experts.5.up_proj"):
        load(sd)


def _loaded(tmp_path):
    directory = write_checkpoint(str(tmp_path / "ckpt"))
    model = loaders.load_model("dsv2-test", dict(_props(directory),
                                                 name="dsv2-test"), Device.CPU)
    assert isinstance(model, loaders.TorchDeepseekV2Model)
    return model


def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join("w" + str(rng.integers(0, 50))
                     for _ in range(int(rng.integers(2, 12))))
            for _ in range(n)]


def test_graphed_key_replays_bit_for_bit_and_counts_expert_tokens(
        tmp_path, monkeypatch):
    from marqo_tpu_torch.api import telemetry
    eager = _loaded(tmp_path)
    model = _loaded(tmp_path)
    model.graphs = graphs.EncoderGraphs("cpu", capture=StandIn())
    for module in (batching, loaders):
        monkeypatch.setattr(module, "graphs_for",
                            lambda m: m.graphs if m is model else None)
    texts = _texts(9)
    first = model.encode(texts)           # packed: capture, then replay
    assert len(model.graphs.graphs) == 1
    before = model.encoder.expert_tokens.clone()
    again = model.encode(texts)           # replay of the captured key
    np.testing.assert_array_equal(first, again)
    np.testing.assert_array_equal(again, eager.encode(texts))
    tokens = sum(min(len(t.encode()) + 1, 64) for t in texts)
    delta = model.encoder.expert_tokens - before
    assert delta.shape == (2, TINY["n_routed_experts"])
    assert delta.sum(1).tolist() == [tokens * TINY["num_experts_per_tok"]] * 2

    # a traced request reads the buffer at its device wait (keys captured
    # before: a capture's warm run counts its tokens too)
    model.encode(texts[:1])
    slots = []
    run = model.graphs.run

    def counted_run(tower, dtype, forward, *inputs, **kwargs):
        slots.append(inputs[0].size)
        return run(tower, dtype, forward, *inputs, **kwargs)

    monkeypatch.setattr(model.graphs, "run", counted_run)
    launched = dict(moe.LAUNCHES)
    metrics = telemetry.RequestMetricsStore.set_in_request(traced=True)
    try:
        model.encode(texts)
        model.encode(texts[:1])           # padded
    finally:
        telemetry.RequestMetricsStore.clear()
    assert metrics.counters["moe.forwards"] == 2
    # the static routed rows: every token slot of both forwards, top k
    # each, in both MoE layers; the real ones are the expert tokens
    assert len(slots) == 2
    assert metrics.counters["moe.static_rows"] == \
        sum(slots) * TINY["num_experts_per_tok"] * 2
    assert metrics.counters["moe.static_rows"] > \
        (tokens + len(texts[0].encode()) + 1) * TINY["num_experts_per_tok"] * 2
    # the passes' counters exist; on the CPU the twins launch nothing
    assert set(moe.LAUNCHES) == {"grouped_mm", "swiglu", "combine"}
    assert moe.LAUNCHES == launched
    logged = [e for e in telemetry.counts("moe.expert_tokens")
              if e.request == metrics.request_id]
    assert len(logged) == 2 and logged[1].values.shape == (2, 8)
    assert logged[1].values.sum(1).tolist() == \
        [(len(texts[0].encode()) + 1) * TINY["num_experts_per_tok"]] * 2


def test_http_api_end_to_end(tmp_path, monkeypatch):
    """An index over a deepseek_v2 checkpoint through the port's HTTP API:
    create, add (packed), search, embed; the stored vectors are the
    reference's."""
    import urllib.request
    directory = write_checkpoint(str(tmp_path / "ckpt"))
    monkeypatch.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")
    monkeypatch.setenv("MARQO_MODELS_TO_PRELOAD", "[]")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    from marqo_tpu_torch.api.app import build_app, generate_config, on_start
    from marqo_tpu_torch.api.http_framework import serve
    config = generate_config()
    on_start(config)
    server = serve(build_app(config), host="127.0.0.1", port=0,
                   background=True)
    port = server.server_address[1]

    def call(method, path, body=None):
        r = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"})
        return json.load(urllib.request.urlopen(r))

    try:
        call("POST", "/indexes/dsv2", {
            "model": "dsv2-e2e", "modelProperties": _props(directory),
            "type": "unstructured",
            "textPreprocessing": {"splitLength": 6, "splitOverlap": 0,
                                  "splitMethod": "sentence"}})
        docs = [{"_id": str(i), "title": t, "body": b} for i, (t, b) in
                enumerate(zip(_texts(5, 1), _texts(5, 2)))]
        added = call("POST", "/indexes/dsv2/documents?telemetry=true",
                     {"documents": docs, "tensorFields": ["title", "body"]})
        assert not added["errors"]
        assert added["telemetry"]["counter"]["moe.forwards"] >= 1
        hits = call("POST", "/indexes/dsv2/search",
                    {"q": docs[2]["title"], "searchableAttributes": ["title"]})
        assert hits["hits"][0]["_id"] == "2"
        embedded = call("POST", "/indexes/dsv2/embed",
                        {"content": [docs[0]["title"]]})
        stored = call("GET", "/indexes/dsv2/documents/0?expose_facets=true")
    finally:
        server.shutdown()
        server.server_close()
        # a later test in this process counts the models it loaded
        from marqo_tpu_torch.inference import vectorise
        vectorise.clear_loaded_models()
    tok = loaders.TextTokenizer.from_pretrained(directory, max_length=64)
    batch = tok.encode_batch([docs[0]["title"]])
    expected = reference_vectors(
        tmp_path, torch.from_numpy(batch["input_ids"]).long(),
        torch.from_numpy(batch["attention_mask"]).long())[0]
    facet = next(f for f in stored["_tensor_facets"] if "title" in f)
    assert float(cosine(facet["_embedding"], expected)) > 0.999
    assert float(cosine(embedded["embeddings"][0], expected)) > 0.999


def test_reference_copies_are_identical():
    assert filecmp.cmp(os.path.join(REPO, "tests", "reference",
                                    "deepseek_v2.py"),
                       os.path.join(REPO, "benchmark", "reference",
                                    "deepseek_v2.py"), shallow=False)
