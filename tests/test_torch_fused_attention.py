"""marqo_tpu_torch flash attention (ops/fused_attention.py) against the JAX
package's ``fused_attention``, whose library Pallas kernel runs in interpret
mode on the CPU as in tests/test_fused_attention.py.

On CPU tensors the port's wrapper takes the plain twin, so these tests hold
the twin's semantics to the TPU kernel's on every row, pad rows included:
fp32 atol 2e-5 (tests/test_fused_attention.py's tolerance), inputs
0.3 * N(0, 1). The kernel's masked modes need S % 128 == 0 there, so they
are compared at S = 128 and 256; no-mask mode at any S. The CUDA kernel is
held against the same twin on the card (chip_smoke.py,
tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.ops.fused_attention import \
    fused_attention as jax_fused_attention
from marqo_tpu_torch.ops import flash_attention as b1
from marqo_tpu_torch.ops import fused_attention as fa


def _qkv(B, N, S, D, seed):
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.standard_normal((B, N, S, D))).astype(np.float32)
            for _ in range(3)]


def _pad_mask(B, S, seed):
    """A full row, a ragged row, and random lengths."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, S + 1, B)
    lengths[:2] = S, S // 3
    return (np.arange(S)[None] < lengths[:, None]).astype(np.int32)


def _packed_segments(B, S, seed):
    """Contiguous runs of ids 1, 2, ... as ops/packing.py lays them out,
    with a pad tail of id 0."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, S), dtype=np.int32)
    for b in range(B):
        pos, sid, end = 0, 1, S - int(rng.integers(1, S // 4))
        while pos < end:
            n = int(rng.integers(4, S // 3))
            seg[b, pos:min(pos + n, end)] = sid
            pos, sid = pos + n, sid + 1
    return seg


def _run_both(q, k, v, **mask):
    ref = np.asarray(jax_fused_attention(
        *(jnp.asarray(a) for a in (q, k, v)),
        **{name: jnp.asarray(m) for name, m in mask.items()},
        interpret=True))
    out = fa.fused_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        **{name: torch.from_numpy(m) for name, m in mask.items()})
    return ref, out.numpy()


@pytest.mark.parametrize("S", [50, 257])
def test_nomask_matches_pallas_on_every_row(S):
    B, N, D = 2, 2, 32
    q, k, v = _qkv(B, N, S, D, seed=S)
    ref, out = _run_both(q, k, v)
    assert out.dtype == np.float32 and out.shape == (B, N, S, D)
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("mode", ["pad_mask", "segment_ids"])
def test_masked_modes_match_pallas_on_every_row(mode, S):
    B, N, D = 3, 2, 32
    q, k, v = _qkv(B, N, S, D, seed=S + 1)
    mask = _pad_mask(B, S, S) if mode == "pad_mask" else \
        _packed_segments(B, S, S)
    ref, out = _run_both(q, k, v, **{mode: mask})
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_pad_mask_is_segment_ids_zero_and_one():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, 40, 16, seed=5))
    pad = torch.from_numpy(_pad_mask(3, 40, 5))
    assert torch.equal(fa.fused_attention(q, k, v, pad_mask=pad),
                       fa.fused_attention(q, k, v, segment_ids=pad))
    assert torch.equal(fa.fused_attention(q, k, v, pad_mask=pad * 7),
                       fa.fused_attention_reference(q, k, v, pad_mask=pad))


def test_bf16_twin_tracks_fp32():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 2, 96, 32, seed=11))
    seg = torch.from_numpy(_packed_segments(2, 96, 11))
    for mask in ({}, {"segment_ids": seg}):
        out32 = fa.fused_attention(q, k, v, **mask)
        out16 = fa.fused_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                   **mask)
        assert out16.dtype == torch.bfloat16
        np.testing.assert_allclose(out16.float().numpy(), out32.numpy(),
                                   atol=2e-2)


@pytest.mark.parametrize("mode", ["padding", "segment"])
def test_agrees_with_b1_on_real_rows_and_differs_on_pad_rows(mode):
    """B1 (ops/flash_attention.py) drops id-0 keys for every query, so its
    pad queries see only real keys (padding) or nothing (segment: the
    uniform mean of V); B2's pad queries attend to each other."""
    B, N, S, D = 3, 2, 64, 16
    q, k, v = (torch.from_numpy(a) for a in _qkv(B, N, S, D, seed=9))
    if mode == "padding":
        mask = torch.from_numpy(_pad_mask(B, S, 9))
        ours = fa.fused_attention(q, k, v, pad_mask=mask)
        theirs = b1.attention_padding(q, k, v, mask)
    else:
        mask = torch.from_numpy(_packed_segments(B, S, 9))
        ours = fa.fused_attention(q, k, v, segment_ids=mask)
        theirs = b1.attention_segment(q, k, v, mask)
    real = (mask > 0)[:, None, :, None].expand_as(ours)
    np.testing.assert_allclose(ours[real].numpy(), theirs[real].numpy(),
                               atol=1e-6)
    pad_rows = (ours - theirs).abs().amax(dim=-1)[~real[..., 0]]
    assert pad_rows.numel() > 0 and bool((pad_rows > 1e-3).all())


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 2, 16, 8, seed=0))
    seg = torch.from_numpy(_packed_segments(2, 16, 0))
    before = dict(fa.LAUNCHES)
    for mask in ({}, {"segment_ids": seg}, {"pad_mask": seg > 0}):
        assert torch.equal(fa.fused_attention(q, k, v, **mask),
                           fa.fused_attention_reference(q, k, v, **mask))
    assert fa.LAUNCHES == before


def test_kernel_route_refuses_other_devices():
    """Off the CPU the wrapper launches the kernel or raises; it never
    falls back to the twin (meta tensors stand in for a device without the
    kernel)."""
    q, k, v = (torch.empty(2, 2, 16, 8, device="meta") for _ in range(3))
    seg = torch.empty(2, 16, dtype=torch.int32, device="meta")
    for mask in ({}, {"segment_ids": seg}, {"pad_mask": seg}):
        with pytest.raises(ValueError, match="unsupported device"):
            fa.fused_attention(q, k, v, **mask)


@pytest.mark.parametrize("S,D", [(1, 8), (50, 64), (257, 64), (577, 64),
                                 (730, 80), (257, 88), (257, 104),
                                 (512, 128)])
def test_kernel_input_checks_accept_the_tower_shapes(S, D):
    for dtype in fa.DTYPES:
        q = torch.zeros(1, 2, S, D, dtype=dtype)
        fa.check_kernel_inputs(q, q, q)
        fa.check_kernel_inputs(q, q, q, torch.ones(1, S, dtype=torch.int32))


@pytest.mark.parametrize("bad", ["head_dim_84", "head_dim_136", "shape",
                                 "dtype", "mixed_dtype", "empty_seq",
                                 "segment_shape", "contiguity", "stride",
                                 "alignment"])
def test_kernel_input_checks_refuse(bad):
    shape, dtype = (2, 2, 16, 64), torch.float32
    if bad == "head_dim_84":
        shape = (2, 2, 16, 84)
    elif bad == "head_dim_136":
        shape = (2, 2, 16, 136)
    elif bad == "empty_seq":
        shape = (2, 2, 0, 64)
    elif bad == "dtype":
        dtype = torch.float16
    q, k, v = (torch.zeros(shape, dtype=dtype) for _ in range(3))
    seg = None
    if bad == "shape":
        v = torch.zeros(2, 2, 17, 64)
    elif bad == "mixed_dtype":
        k = k.bfloat16()
    elif bad == "segment_shape":
        seg = torch.ones(2, 15, dtype=torch.int32)
    elif bad == "contiguity":
        # the last axis is not contiguous
        q = torch.zeros(2, 2, 64, 16).transpose(2, 3)
    elif bad == "stride":
        # tokens 68 elements apart: rows not on 16-byte boundaries
        q = torch.zeros(2, 2, 16, 68)[..., :64]
    elif bad == "alignment":
        v = torch.zeros(2 * 2 * 16 * 64 + 2)[2:].view(shape)
    match = {"contiguity": "contiguous", "stride": "multiples of 8",
             "alignment": "aligned"}.get(bad)
    with pytest.raises(ValueError, match=match):
        fa.check_kernel_inputs(q, k, v, seg)


def _projection_views(B, N, S, D, device="meta"):
    """q, k, v as the ViT blocks hand them over (views of one (B, S, N*D)
    projection output each), and as chunks of one fused (B, S, 3*N*D)
    projection."""
    def heads(t):
        return t.reshape(B, S, N, D).transpose(1, 2)
    separate = [heads(torch.empty(B, S, N * D, device=device))
                for _ in range(3)]
    fused = torch.empty(B, S, 3 * N * D, device=device)
    return {"projection": separate,
            "fused_qkv": [heads(t) for t in fused.chunk(3, dim=-1)]}


@pytest.mark.parametrize("layout", ["projection", "fused_qkv"])
@pytest.mark.parametrize("D", [8, 24, 64, 80, 104, 128])
def test_kernel_input_checks_accept_the_projection_layouts(D, layout):
    q, k, v = _projection_views(2, 3, 257, D)[layout]
    assert not q.is_contiguous()
    fa.check_kernel_inputs(q, k, v)
    fa.check_kernel_inputs(q, k, v, torch.ones(2, 257, dtype=torch.int32))


@pytest.mark.parametrize("layout", ["projection", "fused_qkv"])
@pytest.mark.parametrize("mode", ["nomask", "pad_mask", "segment_ids"])
def test_twin_takes_strided_views(mode, layout):
    """The plain twin gives on the projections' views what it gives on
    contiguous copies of the same values."""
    B, N, S, D = 3, 2, 50, 32
    views = _projection_views(B, N, S, D, device="cpu")[layout]
    for view, values in zip(views, _qkv(B, N, S, D, seed=21)):
        view.copy_(torch.from_numpy(values))
    mask = {"nomask": {},
            "pad_mask": {"pad_mask": torch.from_numpy(_pad_mask(B, S, 21))},
            "segment_ids": {"segment_ids": torch.from_numpy(
                _packed_segments(B, S, 21))}}[mode]
    out = fa.fused_attention(*views, **mask)
    ref = fa.fused_attention(*(t.contiguous() for t in views), **mask)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)


@pytest.mark.parametrize("layout", ["padded", "packed"])
def test_bert_flash_mode_pools_as_the_b1_path(layout):
    """models/bert.py attention_impl="flash" runs B2; its pad rows differ
    from B1's, but no real token ever attends to one, so the pooled
    embeddings agree."""
    from dataclasses import replace

    from marqo_tpu_torch.models.bert import (TextEncoderConfig,
                                             encode_tokens,
                                             encode_tokens_packed,
                                             init_encoder)
    from marqo_tpu_torch.ops.packing import pack_sequences
    config = TextEncoderConfig(vocab_size=64, hidden_size=32, num_layers=2,
                               num_heads=2, intermediate_size=64)
    encoder = init_encoder(config, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(0)
    B, S = 6, 32
    lengths = rng.integers(3, S + 1, B)
    ids = rng.integers(5, 64, (B, S)).astype(np.int32)
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
    packed = pack_sequences([ids[i, :lengths[i]] for i in range(B)],
                            seq_len=S, pad_id=0)
    out = {}
    for impl in ("kernel", "flash"):
        encoder.config = replace(config, attention_impl=impl)
        if layout == "padded":
            out[impl] = encode_tokens(encoder, torch.from_numpy(ids * mask),
                                      torch.from_numpy(mask))
        else:
            out[impl] = encode_tokens_packed(
                encoder, *(torch.from_numpy(getattr(packed, name)) for name in
                           ("input_ids", "segment_ids", "positions",
                            "seq_index")), packed.n_sequences)
    np.testing.assert_allclose(out["flash"].numpy(), out["kernel"].numpy(),
                               atol=1e-6)
