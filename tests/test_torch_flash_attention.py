"""marqo_tpu_torch masked attention (ops/flash_attention.py) against the JAX
package's Pallas kernel, which runs in interpret mode on the CPU as in
tests/test_flash_attention.py.

On CPU tensors the port's public wrappers take the plain twin, so these
tests hold the twin's semantics to the TPU kernel's: fp32 atol 1e-5 (the
tolerance of tests/test_flash_attention.py), on every row, including fully
masked rows (uniform mean of V) and pad queries in segment mode. The CUDA
kernel is held against the same twin on the card (chip_smoke.py phase 3,
tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.ops import flash_attention as jax_fa
from marqo_tpu_torch.ops import flash_attention as fa


def _qkv(B, N, S, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, S, D)).astype(np.float32)
            for _ in range(3)]


def _pad_mask(B, S, seed):
    """Full, ragged, 1-token and all-pad rows."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, S + 1, B)
    lengths[:4] = S, S // 2, 1, 0
    return (np.arange(S)[None] < lengths[:, None]).astype(np.int32)


def _segment_ids(B, S, seed):
    """Several documents per row with a pad tail (pad queries), one row
    holding a single document and one all-pad row."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, S), dtype=np.int32)
    for b in range(B - 1):
        pos, sid = 0, 1
        end = S - 3 if b else S
        while pos < end:
            n = int(rng.integers(1, max(2, S // 3)))
            seg[b, pos:min(pos + n, end)] = sid
            pos, sid = pos + n, sid + 1
    seg[1] = np.where(seg[1] > 0, 1, 0)
    return seg


def _run_both(mode, q, k, v, mask):
    jax_fn = {"padding": jax_fa.attention_padding,
              "segment": jax_fa.attention_segment}[mode]
    torch_fn = {"padding": fa.attention_padding,
                "segment": fa.attention_segment}[mode]
    ref = np.asarray(jax_fn(*(jnp.asarray(a) for a in (q, k, v, mask))))
    out = torch_fn(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    return ref, out.numpy()


@pytest.mark.parametrize("S", [16, 32, 64])
@pytest.mark.parametrize("mode", ["padding", "segment"])
def test_matches_pallas_kernel_on_every_row(mode, S):
    B, N, D = 5, 2, 16
    q, k, v = _qkv(B, N, S, D, seed=S)
    mask = _pad_mask(B, S, S) if mode == "padding" else _segment_ids(B, S, S)
    ref, out = _run_both(mode, q, k, v, mask)
    assert out.dtype == np.float32 and out.shape == (B, N, S, D)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("D", [48, 72, 80])
@pytest.mark.parametrize("mode", ["padding", "segment"])
def test_matches_pallas_kernel_at_the_head_dims_c1_added(mode, D):
    """Head dims the CUDA kernel took only after ROADMAP C1 (48: a 384-wide
    8-head encoder; 72: SigLIP SO400M; 80) through the twin, against the
    TPU kernel in interpret mode."""
    B, N, S = 5, 2, 32
    q, k, v = _qkv(B, N, S, D, seed=D)
    mask = _pad_mask(B, S, D) if mode == "padding" else _segment_ids(B, S, D)
    ref, out = _run_both(mode, q, k, v, mask)
    assert out.shape == (B, N, S, D)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [48, 80])
@pytest.mark.parametrize("mode", ["padding", "segment"])
def test_kernel_at_the_head_dims_c1_added_matches_twin(mode, D, dtype):
    """On the card: the CUDA kernel at D = 48 and 80, in the encoders'
    projection layout, against its twin (chip_smoke.check_attention's
    bounds, the x0.9 softmax-scale control included in bf16)."""
    from chip_smoke import (SCALE_CONTROL, attention_inputs,
                            check_attention, projection_views)
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (the kernel has no CPU mode)")
    q, k, v, pad, seg = attention_inputs(8, 4, 128, D, dtype, seed=D)
    q, k, v = projection_views(q, k, v, "projection")
    mask = pad if mode == "padding" else seg
    kernel = {"padding": fa.attention_padding,
              "segment": fa.attention_segment}[mode]
    plain = {"padding": fa.attention_padding_reference,
             "segment": fa.attention_segment_reference}[mode]
    before = fa.LAUNCHES[mode]
    out = kernel(q, k, v, mask)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[mode] == before + 1
    check_attention(out, plain(q, k, v, mask),
                    plain(q * SCALE_CONTROL, k, v, mask), f"{mode} D={D}")


@pytest.mark.parametrize("mode", ["padding", "segment"])
def test_fully_masked_rows_average_v_uniformly(mode):
    B, N, S, D = 4, 2, 16, 8
    q, k, v = _qkv(B, N, S, D, seed=7)
    mask = np.zeros((B, S), dtype=np.int32)  # nothing may be attended
    ref, out = _run_both(mode, q, k, v, mask)
    uniform = np.broadcast_to(v.mean(axis=2, keepdims=True), v.shape)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, uniform, atol=1e-5)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_segment_pad_queries_match_pallas():
    """Pad queries (segment 0) in a packed row: no key is allowed, so they
    come out as the uniform mean, exactly as the TPU kernel defines them."""
    B, N, S, D = 2, 2, 32, 8
    q, k, v = _qkv(B, N, S, D, seed=3)
    seg = np.zeros((B, S), dtype=np.int32)
    seg[0, :10], seg[0, 10:20] = 1, 2
    seg[1, :25] = 1
    ref, out = _run_both("segment", q, k, v, seg)
    np.testing.assert_allclose(out[0, :, 20:], ref[0, :, 20:], atol=1e-5)
    np.testing.assert_allclose(
        out[0, :, 20:], np.broadcast_to(v[0].mean(1, keepdims=True),
                                        (N, 12, D)), atol=1e-5)
    # real tokens never see the other document or the pad tail
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_bf16_twin_tracks_fp32():
    B, N, S, D = 4, 2, 32, 16
    q, k, v = _qkv(B, N, S, D, seed=11)
    mask = torch.from_numpy(_pad_mask(B, S, 1))
    args = [torch.from_numpy(a) for a in (q, k, v)]
    out32 = fa.attention_padding(*args, mask)
    out16 = fa.attention_padding(*(a.bfloat16() for a in args), mask)
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(out16.float().numpy(), out32.numpy(),
                               atol=5e-2)


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 2, 16, 8, seed=0))
    before = dict(fa.LAUNCHES)
    out = fa.attention_segment(q, k, v, torch.ones(2, 16, dtype=torch.int32))
    ref = fa.attention_segment_reference(
        q, k, v, torch.ones(2, 16, dtype=torch.int32))
    assert torch.equal(out, ref)
    assert fa.LAUNCHES == before


def test_kernel_route_refuses_other_devices():
    """Off the CPU the wrapper launches the kernel or raises — it never
    falls back to the twin (meta tensors stand in for a device without
    the kernel)."""
    q, k, v = (torch.empty(2, 2, 16, 8, device="meta") for _ in range(3))
    mask = torch.empty(2, 16, dtype=torch.int32, device="meta")
    for fn in (fa.attention_padding, fa.attention_segment):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, k, v, mask)


@pytest.mark.parametrize("bad", ["dtype", "shape", "mask", "seq_len",
                                 "head_dim", "contiguity", "stride",
                                 "alignment"])
def test_kernel_input_checks(bad):
    shape, dtype = (2, 2, 16, 8), torch.float32
    if bad == "seq_len":
        shape = (1, 1, fa.MAX_SEQ_LEN + 1, 8)
    elif bad == "head_dim":
        # not a multiple of 8 (every multiple of 8 up to 128 is taken)
        shape = (2, 2, 16, 20)
    elif bad == "dtype":
        dtype = torch.float16
    q, k, v = (torch.zeros(shape, dtype=dtype) for _ in range(3))
    mask = torch.ones(shape[0], shape[2], dtype=torch.int32)
    if bad == "shape":
        v = torch.zeros(2, 2, 16, 16)
    elif bad == "mask":
        mask = torch.ones(2, 15, dtype=torch.int32)
    elif bad == "contiguity":
        # the last axis is not contiguous
        q = torch.zeros(2, 2, 8, 16).transpose(2, 3)
    elif bad == "stride":
        # tokens 12 elements apart: rows not on 16-byte boundaries
        q = torch.zeros(2, 2, 16, 12)[..., :8]
    elif bad == "alignment":
        q = torch.zeros(2 * 2 * 16 * 8 + 1)[1:].view(shape)
    match = {"contiguity": "contiguous", "stride": "multiples of 8",
             "alignment": "aligned"}.get(bad)
    with pytest.raises(ValueError, match=match):
        fa.check_kernel_inputs(q, k, v, mask)


def _projection_views(B, N, S, D, dtype=torch.float32, device="meta"):
    """q, k, v as the encoders hand them over: views of one (B, S, N*D)
    projection output each, and Stella's chunks of one fused
    (B, S, 3*N*D) qkv projection."""
    def heads(t):
        return t.view(B, S, N, D).transpose(1, 2)
    separate = [heads(torch.empty(B, S, N * D, dtype=dtype, device=device))
                for _ in range(3)]
    fused = torch.empty(B, S, 3 * N * D, dtype=dtype, device=device)
    chunks = [t.reshape(B, S, N, D).transpose(1, 2)
              for t in fused.chunk(3, dim=-1)]
    return {"projection": separate, "fused_qkv": chunks}


@pytest.mark.parametrize("layout", ["projection", "fused_qkv"])
def test_kernel_input_checks_accept_the_projection_layouts(layout):
    for dtype in fa.DTYPES:
        for D in fa.HEAD_DIMS:
            q, k, v = _projection_views(2, 3, 16, D, dtype)[layout]
            assert not q.is_contiguous()
            fa.check_kernel_inputs(q, k, v,
                                   torch.ones(2, 16, dtype=torch.int32))


def test_kernel_output_is_the_projection_layout():
    q = torch.empty(2, 3, 16, 64, device="meta")
    out = fa.kernel_output(q)
    assert out.shape == q.shape and out.transpose(1, 2).is_contiguous()
    assert list(fa.kernel_strides(q, q, q, out)) == \
        [3 * 16 * 64, 16 * 64, 64] * 3 + [16 * 3 * 64, 64, 3 * 64]


@pytest.mark.parametrize("layout", ["projection", "fused_qkv"])
@pytest.mark.parametrize("mode", ["padding", "segment"])
def test_twins_take_strided_views(mode, layout):
    """The plain twins give on the projections' views what they give on
    contiguous copies of the same values."""
    B, N, S, D = 5, 2, 32, 16
    views = _projection_views(B, N, S, D, device="cpu")[layout]
    for view, values in zip(views, _qkv(B, N, S, D, seed=13)):
        view.copy_(torch.from_numpy(values))
    mask = torch.from_numpy(_pad_mask(B, S, 13) if mode == "padding"
                            else _segment_ids(B, S, 13))
    fn = {"padding": fa.attention_padding,
          "segment": fa.attention_segment}[mode]
    out = fn(*views, mask)
    ref = fn(*(t.contiguous() for t in views), mask)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)


def test_kernel_input_checks_accept_the_encoder_shapes():
    for dtype in fa.DTYPES:
        for S in (16, 128, 512):
            q = torch.zeros(1, 12, S, 64, dtype=dtype)
            fa.check_kernel_inputs(q, q, q, torch.ones(1, S, dtype=torch.int32))
