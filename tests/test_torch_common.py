"""marqo_tpu_torch/ops/common.py against marqo_tpu/ops/common.py on the same
numpy inputs: LayerNorm (fp32 statistics in both dtypes), the activation
table, L2 normalization and the two poolings."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.ops import common as jc
from marqo_tpu_torch.ops import common as tc


def _x(shape=(3, 7, 64), seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + 0.5).astype(np.float32)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_layer_norm(dtype, atol):
    x, scale, bias = _x(), _x((64,), 1, 1.0), _x((64,), 2, 1.0)
    ref = jc.layer_norm(*(jnp.asarray(a, dtype) for a in (x, scale, bias)))
    out = tc.layer_norm(*(torch.from_numpy(a).to(getattr(torch, dtype))
                          for a in (x, scale, bias)))
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


@pytest.mark.parametrize("name", sorted(jc.ACTIVATIONS))
def test_activations(name):
    assert set(tc.ACTIVATIONS) == set(jc.ACTIVATIONS)
    x = _x(seed=3)
    ref = np.asarray(jc.ACTIVATIONS[name](jnp.asarray(x)))
    out = tc.ACTIVATIONS[name](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_l2_normalize():
    x = _x((5, 16), seed=4)
    x[0] = 0.0  # the eps floor keeps a zero vector finite
    ref = np.asarray(jc.l2_normalize(jnp.asarray(x)))
    out = tc.l2_normalize(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2)
    np.testing.assert_allclose(
        tc.l2_normalize(torch.from_numpy(x)).numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("pool", ["masked_mean_pool", "cls_pool"])
def test_pooling(pool):
    hidden = _x((4, 9, 16), seed=5)
    mask = (np.arange(9)[None] < np.array([9, 3, 1, 0])[:, None]).astype(
        np.int32)
    ref = np.asarray(getattr(jc, pool)(jnp.asarray(hidden),
                                       jnp.asarray(mask)))
    out = getattr(tc, pool)(torch.from_numpy(hidden), torch.from_numpy(mask))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_fp32_convolutions_nests_and_restores(monkeypatch):
    """cuDNN's TF32 stays off while any block is open, whichever of two
    overlapping blocks closes first, and the setting the first block found
    comes back after the last."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    first, second = tc.fp32_convolutions(), tc.fp32_convolutions()
    first.__enter__()
    assert torch.backends.cudnn.allow_tf32 is False
    second.__enter__()
    first.__exit__(None, None, None)
    assert torch.backends.cudnn.allow_tf32 is False
    second.__exit__(None, None, None)
    assert torch.backends.cudnn.allow_tf32 is True
