"""marqo_tpu_torch's YOLOX-S (models/yolox.py) against marqo_tpu's.

The same weights go to both packages: marqo_tpu's pytree with every array
perturbed and the BatchNorm statistics drawn at random (the init's mean 0
and var 1 would hide a wrong fold), the stem's weights / 255 so the raw
0-255 pixels leave activations of order 1 (with the init's weights the
head logits reach 1e4 and the sigmoids saturate). Tolerance: fp32, each
output group (xy, wh, objectness, classes) within 1e-4 of that group's
largest magnitude. A Focus stem with two slices swapped, or a neck concat
in the reverse order, still runs and gives boxes; both must miss by more
than the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.models import yolox as jyolo
from marqo_tpu_torch.models import yolox as tyolo

TOL = 1e-4
GROUPS = {"xy": slice(0, 2), "wh": slice(2, 4), "objectness": slice(4, 5),
          "classes": slice(5, None)}


def _random_stats(tree, rng):
    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        shape = np.shape(node)
        if key == "bn_mean":
            return rng.normal(0, 0.3, shape).astype(np.float32)
        if key == "bn_var":
            return rng.uniform(0.3, 2.0, shape).astype(np.float32)
        return (np.asarray(node, np.float32) +
                0.05 * rng.standard_normal(shape)).astype(np.float32)
    return walk(tree)


@pytest.fixture(scope="module", params=[64, 96])
def case(request):
    size = request.param
    jconfig = jyolo.YoloxConfig(width=0.125, input_size=size)
    params = _random_stats(
        jax.tree.map(np.asarray, jyolo.init_params(jconfig,
                                                   jax.random.PRNGKey(0))),
        np.random.default_rng(1))
    params["backbone"]["stem"]["conv"]["w"] /= 255.0
    pixels = np.random.default_rng(2).uniform(
        0, 255, (2, size, size, 3)).astype(np.float32)
    expected = np.asarray(jyolo.forward_jit(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pixels), jconfig))
    tconfig = tyolo.YoloxConfig(width=0.125, input_size=size)
    return params, tconfig, pixels, expected


def _port(params, config, pixels):
    model = tyolo.params_from_jax(params, config, device="cpu")
    with torch.inference_mode():
        return model(torch.from_numpy(pixels)).numpy()


def _group_errors(got, expected):
    return {name: float(np.abs(got[..., s] - expected[..., s]).max() /
                        np.abs(expected[..., s]).max())
            for name, s in GROUPS.items()}


def test_forward_matches_jax(case):
    params, config, pixels, expected = case
    got = _port(params, config, pixels)
    size = config.input_size
    n = sum((size // s) ** 2 for s in (8, 16, 32))
    assert got.shape == expected.shape == (2, n, 85)
    assert got.dtype == np.float32
    errors = _group_errors(got, expected)
    assert max(errors.values()) <= TOL, errors


def test_focus_with_two_slices_swapped_misses(case, monkeypatch):
    def swapped(x):
        return torch.cat([x[:, :, 1::2, ::2], x[:, :, ::2, ::2],
                          x[:, :, ::2, 1::2], x[:, :, 1::2, 1::2]], dim=1)

    params, config, pixels, expected = case
    monkeypatch.setattr(tyolo, "focus_slices", swapped)
    errors = _group_errors(_port(params, config, pixels), expected)
    assert max(errors.values()) > 10 * TOL, errors


@pytest.mark.parametrize("csp", ["c3_p4", "c3_p3", "c3_n3", "c3_n4"])
def test_reversed_neck_concat_misses(case, csp):
    """A neck concat [b, a] in place of [a, b] is the right concat feeding
    a CSP layer whose two input convs have their input-channel halves
    swapped: both operands have the same width, so it runs."""
    params, config, pixels, expected = case
    model = tyolo.params_from_jax(params, config, device="cpu")
    layer = model.neck[csp]
    with torch.no_grad():
        for conv in (layer.conv1, layer.conv2):
            half = conv.w.shape[1] // 2
            conv.w.copy_(torch.cat([conv.w[:, half:], conv.w[:, :half]], 1))
        wrong = model(torch.from_numpy(pixels)).numpy()
    errors = _group_errors(wrong, expected)
    assert max(errors.values()) > 10 * TOL, errors


def test_decode_outputs_is_identical():
    rng = np.random.default_rng(0)
    for size in ((64, 64), (96, 64), (384, 384)):
        n = sum((size[0] // s) * (size[1] // s) for s in (8, 16, 32))
        outputs = (3 * rng.standard_normal((2, n, 85))).astype(np.float32)
        got = tyolo.decode_outputs(outputs, size)
        np.testing.assert_array_equal(got, jyolo.decode_outputs(outputs,
                                                                size))


@pytest.mark.parametrize("shape", [(1, 4, 3, 5), (2, 6, 12, 12)])
def test_upsample_and_spp_pools_equal_jax(shape):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    up = tyolo.upsample2(t).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(up, np.asarray(jyolo._upsample2(
        jnp.asarray(x))))
    for k in (5, 9, 13):
        pooled = tyolo.spp_pool(t, k)
        expected = jax.lax.reduce_window(
            jnp.asarray(x), -jnp.inf, jax.lax.max, (1, k, k, 1),
            (1, 1, 1, 1), [(0, 0), (k // 2, k // 2), (k // 2, k // 2),
                           (0, 0)])
        np.testing.assert_array_equal(pooled.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(expected))


def test_forward_runs_convolutions_without_tf32(monkeypatch):
    """cuDNN's TF32 is off inside the forward, where a served process has
    PyTorch's default (on), and back on after it."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    model = tyolo.init_params(tyolo.YoloxConfig(width=0.125, input_size=64),
                            torch.Generator().manual_seed(0), device="cpu")
    seen = []
    model.backbone.stem.conv.register_forward_pre_hook(
        lambda module, args: seen.append(torch.backends.cudnn.allow_tf32))
    with torch.inference_mode():
        model(torch.zeros(1, 64, 64, 3))
    assert seen == [False]
    assert torch.backends.cudnn.allow_tf32 is True
