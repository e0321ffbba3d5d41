"""marqo_tpu_torch's CUDA kernels against their plain twins, on the card:
B1 (ops/flash_attention.py, masked attention), B2 (ops/fused_attention.py,
flash attention with no mask or segment ids) and B3 (ops/quant_matmul.py,
the fused W8A8 linear layer).
Skips without an sm_90 CUDA device and nvcc; on a Hopper host run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the port's host
need not have). Tolerances: attention fp32 atol 1e-5, bf16 atol 2e-2, as
chip_smoke.py's kernel phases; B3 as its quant_kernel phase.
"""

import pytest
import torch

import chip_smoke
from chip_smoke import attention_inputs, w8a8_inputs
from marqo_tpu_torch.ops import _build
from marqo_tpu_torch.ops import flash_attention as fa
from marqo_tpu_torch.ops import fused_attention as fused
from marqo_tpu_torch.ops import quant_matmul as qm

pytestmark = pytest.mark.cuda

ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


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
@pytest.mark.parametrize("D", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("S", [1, 16, 32, 100, 128, 512])
def test_kernel_matches_twin(card, S, D, dtype):
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
        err = float((out.float() - plain(q, k, v, mask).float()).abs().max())
        assert err <= ATOL[dtype], (mode, err)


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
        ref = fused.fused_attention_reference(q, k, v, **mask)
        err = float((out.float() - ref.float()).abs().max())
        assert err <= ATOL[dtype], (name, err)


def test_fused_kernel_refuses_non_contiguous_input(card):
    q, k, v, _, seg = attention_inputs(2, 16, 50, 64, torch.float32, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                              k, v, segment_ids=seg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", chip_smoke.W8A8_WIDTHS)
@pytest.mark.parametrize("M", [1, 32, 37, 4096, 17408])
def test_w8a8_kernel_matches_twin(card, M, K, N, dtype):
    """B3 against its twin: fp32 within 1e-5 of max |ref|, bf16 within one
    bf16 ulp (chip_smoke.py's w8a8_error)."""
    x, w_q, w_scale, bias = w8a8_inputs(M, K, N, dtype, seed=M + K + N)
    before = qm.LAUNCHES["w8a8"]
    out = qm.w8a8_matmul(x, w_q, w_scale, bias)
    torch.cuda.synchronize()
    assert qm.LAUNCHES["w8a8"] == before + 1
    assert out.dtype == dtype and tuple(out.shape) == (M, N)
    assert torch.isfinite(out).all()
    ref = qm.w8a8_matmul_reference(x, w_q, w_scale, bias)
    assert chip_smoke.w8a8_error(out, ref) <= chip_smoke.W8A8_TOLERANCE[
        str(dtype).split(".")[-1]]


@pytest.mark.parametrize("M,K,N", [(5, 16, 1), (3, 48, 13), (130, 80, 129)])
def test_w8a8_kernel_ragged_edges(card, M, K, N):
    """K tails shorter than a 64-byte stage, odd N (no paired stores) and
    tiles that overhang M and N."""
    x, w_q, w_scale, bias = w8a8_inputs(M, K, N, torch.float32, seed=M * N)
    out = qm.w8a8_matmul(x, w_q, w_scale, bias)
    ref = qm.w8a8_matmul_reference(x, w_q, w_scale, bias)
    assert chip_smoke.w8a8_error(out, ref) <= 1e-5


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
