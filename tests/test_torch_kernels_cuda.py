"""marqo_tpu_torch's CUDA attention kernels against their plain twins, on
the card: B1 (ops/flash_attention.py, masked attention) and B2
(ops/fused_attention.py, flash attention with no mask or segment ids).
Skips without an sm_90 CUDA device and nvcc; on a Hopper host run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the port's host
need not have). Tolerances: fp32 atol 1e-5, bf16 atol 2e-2, as
chip_smoke.py phase 3.
"""

import pytest
import torch

import chip_smoke
from chip_smoke import attention_inputs
from marqo_tpu_torch.ops import _build
from marqo_tpu_torch.ops import flash_attention as fa
from marqo_tpu_torch.ops import fused_attention as fused

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
