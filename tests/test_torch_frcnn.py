"""marqo_tpu_torch's Faster R-CNN proposer (models/frcnn.py) against
marqo_tpu's.

The same weights go to both packages (marqo_tpu's pytree at width 0.125,
every array perturbed) with the same normalized 64 px pixels. Tolerance:
fp32, each level's objectness and deltas within 1e-4 of that tensor's
largest magnitude. The stem's max pool and the FPN's nearest x2 are held to
the JAX operations exactly, and ``decode_proposals`` (a numpy copy) to the
JAX package's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.models import frcnn as jfrcnn
from marqo_tpu_torch.models import frcnn as tfrcnn

TOL = 1e-4
SIZE = 64


@pytest.fixture(scope="module")
def outputs():
    jconfig = jfrcnn.FrcnnConfig(width=0.125, input_size=SIZE)
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: (np.asarray(a, np.float32) + 0.05 * rng.standard_normal(
            np.shape(a))).astype(np.float32),
        jfrcnn.init_params(jconfig, jax.random.PRNGKey(0)))
    pixels = np.random.default_rng(2).standard_normal(
        (2, SIZE, SIZE, 3)).astype(np.float32)
    expected = [tuple(np.asarray(t) for t in level) for level in
                jfrcnn.forward_jit(jax.tree.map(jnp.asarray, params),
                                   jnp.asarray(pixels), jconfig)]
    tconfig = tfrcnn.FrcnnConfig(width=0.125, input_size=SIZE)
    model = tfrcnn.params_from_jax(params, tconfig, device="cpu")
    with torch.inference_mode():
        got = [tuple(t.numpy() for t in level)
               for level in model(torch.from_numpy(pixels))]
    return got, expected, tconfig, jconfig


@pytest.mark.parametrize("level", range(5))
def test_level_outputs_match_jax(outputs, level):
    got, expected, config, _ = outputs
    side = SIZE // 4 // 2 ** level
    A = len(config.anchor_ratios)
    for ours, theirs, width in zip(got[level], expected[level], (A, 4 * A)):
        assert ours.shape == theirs.shape == (2, side, side, width)
        err = np.abs(ours - theirs).max() / np.abs(theirs).max()
        assert err <= TOL, (level, err)


def test_decode_proposals_is_identical(outputs):
    _, expected, tconfig, jconfig = outputs
    boxes, scores = tfrcnn.decode_proposals(expected, tconfig)
    jboxes, jscores = jfrcnn.decode_proposals(expected, jconfig)
    np.testing.assert_array_equal(boxes, jboxes)
    np.testing.assert_array_equal(scores, jscores)
    n = sum((SIZE // 4 // 2 ** i) ** 2 for i in range(5)) * 3
    assert boxes.shape == (n, 4) and scores.shape == (n,)


@pytest.mark.parametrize("shape", [(1, 7, 9, 3), (2, 16, 16, 4),
                                   (1, 5, 5, 2)])
def test_stem_pool_equals_reduce_window(shape):
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    got = tfrcnn.stem_pool(torch.from_numpy(x).permute(0, 3, 1, 2))
    expected = jax.lax.reduce_window(
        jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
        [(0, 0), (1, 1), (1, 1), (0, 0)])
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(expected))


@pytest.mark.parametrize("shape", [(1, 2, 3, 4), (2, 6, 6, 8)])
def test_nearest_upsample_equals_jax_resize(shape):
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    got = tfrcnn.upsample2(torch.from_numpy(x).permute(0, 3, 1, 2))
    B, H, W, C = shape
    expected = jax.image.resize(jnp.asarray(x), (B, 2 * H, 2 * W, C),
                                "nearest")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(expected))


def test_forward_runs_convolutions_without_tf32(monkeypatch):
    """cuDNN's TF32 is off inside the forward, where a served process has
    PyTorch's default (on), and back on after it."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    model = tfrcnn.init_params(tfrcnn.FrcnnConfig(width=0.125, input_size=64),
                            torch.Generator().manual_seed(0), device="cpu")
    seen = []
    model.backbone.stem.register_forward_pre_hook(
        lambda module, args: seen.append(torch.backends.cudnn.allow_tf32))
    with torch.inference_mode():
        model(torch.zeros(1, 64, 64, 3))
    assert seen == [False]
    assert torch.backends.cudnn.allow_tf32 is True
