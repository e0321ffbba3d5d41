"""marqo_tpu_torch's DINO ViT (models/dino_vit.py) against marqo_tpu's.

The same weights go to both packages: marqo_tpu's pytree (every array
perturbed) through ``params_from_jax``, or one facebookresearch-layout state
dict through each package's converter. Tolerances: fp32 maps within 1e-5
(the JAX package's own torch-mirror bound); bf16 maps at cosine >= 0.999 per
head (the port's blocks 1..L-1 compute the attention scores in fp32 on the
twin, the JAX package in bf16). A depth-1 ViT runs only the last block,
which must round as the JAX package does: there the port's bf16 maps equal
marqo_tpu's within 1e-6, and a last block that computed its scores in fp32
misses that by far.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.models import dino_vit as jdino
from marqo_tpu_torch.models import dino_vit as tdino

SMALL = dict(image_size=64, patch_size=16, hidden_size=64, num_heads=2)


def _perturbed(params, seed=1, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32) + scale * rng.standard_normal(
            np.shape(a))).astype(np.float32), params)


def _pixels(B=2, size=64, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (B, size, size, 3)).astype(np.uint8)


def _port_maps(params, config, pixels, dtype):
    model = tdino.params_from_jax(params, config, dtype=dtype, device="cpu")
    with torch.inference_mode():
        return model.last_selfattention(torch.from_numpy(pixels)).numpy()


def _jax_maps(params, config, pixels, dtype):
    return np.asarray(jdino.last_selfattention(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pixels), config,
        compute_dtype=dtype))


def _head_cosines(a, b):
    a = a.reshape(-1, a.shape[-2] * a.shape[-1]).astype(np.float64)
    b = b.reshape(-1, b.shape[-2] * b.shape[-1]).astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) *
                              np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("layers, size", [(2, 64), (3, 64), (2, 96)])
def test_last_selfattention_fp32_matches_jax(layers, size):
    jconfig = jdino.DinoViTConfig(**{**SMALL, "image_size": size},
                                  num_layers=layers)
    tconfig = tdino.DinoViTConfig(**{**SMALL, "image_size": size},
                                  num_layers=layers)
    params = _perturbed(jdino.init_params(jconfig, jax.random.PRNGKey(0)))
    pixels = _pixels(size=size)
    got = _port_maps(params, tconfig, pixels, torch.float32)
    expected = _jax_maps(params, jconfig, pixels, jnp.float32)
    n_side = size // 16
    assert got.shape == (2, 2, n_side, n_side)
    np.testing.assert_allclose(got, expected, atol=1e-5, rtol=0)


@pytest.mark.parametrize("layers", [2, 4])
def test_last_selfattention_bf16_cosine(layers):
    jconfig = jdino.DinoViTConfig(**SMALL, num_layers=layers)
    tconfig = tdino.DinoViTConfig(**SMALL, num_layers=layers)
    params = _perturbed(jdino.init_params(jconfig, jax.random.PRNGKey(2)))
    pixels = _pixels(seed=3)
    got = _port_maps(params, tconfig, pixels, torch.bfloat16)
    expected = _jax_maps(params, jconfig, pixels, jnp.bfloat16)
    assert np.isfinite(got).all()
    assert _head_cosines(got, expected).min() >= 0.999


def _sharp_depth1():
    """A one-block ViT whose q and k weights are 10x the init's, so the
    CLS scores span several units and their bf16 rounding shows in the
    maps; the init's zero biases keep the projections' rounding equal in
    both packages."""
    jconfig = jdino.DinoViTConfig(**SMALL, num_layers=1)
    tconfig = tdino.DinoViTConfig(**SMALL, num_layers=1)
    params = jax.tree.map(np.asarray,
                          jdino.init_params(jconfig, jax.random.PRNGKey(0)))
    layers = dict(params["layers"])
    layers["q_w"] = layers["q_w"] * 10
    layers["k_w"] = layers["k_w"] * 10
    return jconfig, tconfig, {**params, "layers": layers}


def test_last_block_rounds_as_jax_in_bf16():
    jconfig, tconfig, params = _sharp_depth1()
    pixels = _pixels()
    got = _port_maps(params, tconfig, pixels, torch.bfloat16)
    expected = _jax_maps(params, jconfig, pixels, jnp.bfloat16)
    assert expected.max() > 0.5   # peaked: the scores span several units
    np.testing.assert_allclose(got, expected, atol=1e-6, rtol=0)


def test_fp32_scores_in_the_last_block_are_detected(monkeypatch):
    """The same check fails a last block that rounds like B2 and its twin
    (scores in fp32)."""
    def fp32_scores(q_cls, k):
        scores = torch.matmul(q_cls.float(), k.float().transpose(-1, -2))
        return torch.softmax(scores / math.sqrt(q_cls.shape[-1]),
                             dim=-1)[:, :, 0]

    jconfig, tconfig, params = _sharp_depth1()
    pixels = _pixels()
    expected = _jax_maps(params, jconfig, pixels, jnp.bfloat16)
    monkeypatch.setattr(tdino, "cls_attention", fp32_scores)
    wrong = _port_maps(params, tconfig, pixels, torch.bfloat16)
    assert np.abs(wrong - expected).max() > 1e-4


def _dino_state_dict(H=32, L=2, n_patches=16, seed=0):
    """A facebookresearch/dino ViT state dict (packed qkv; the mirror of
    tests/test_patch_models.py's)."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=0.1):
        return torch.randn(*shape, generator=g) * std

    sd = {"cls_token": rnd(1, 1, H, std=0.02),
          "pos_embed": rnd(1, n_patches + 1, H, std=0.02),
          "patch_embed.proj.weight": rnd(H, 3, 16, 16, std=0.02),
          "patch_embed.proj.bias": rnd(H, std=0.02),
          "norm.weight": 1 + rnd(H), "norm.bias": rnd(H)}
    for i in range(L):
        p = f"blocks.{i}."
        sd.update({
            p + "norm1.weight": 1 + rnd(H), p + "norm1.bias": rnd(H),
            p + "attn.qkv.weight": rnd(3 * H, H),
            p + "attn.qkv.bias": rnd(3 * H, std=0.02),
            p + "attn.proj.weight": rnd(H, H), p + "attn.proj.bias": rnd(H),
            p + "norm2.weight": 1 + rnd(H), p + "norm2.bias": rnd(H),
            p + "mlp.fc1.weight": rnd(4 * H, H),
            p + "mlp.fc1.bias": rnd(4 * H),
            p + "mlp.fc2.weight": rnd(H, 4 * H), p + "mlp.fc2.bias": rnd(H)})
    return sd


def test_dino_state_dict_converter_matches_jax():
    sd = _dino_state_dict()
    jconfig = jdino.DinoViTConfig(image_size=64, patch_size=16,
                                  hidden_size=32, num_layers=2, num_heads=4)
    tconfig = tdino.DinoViTConfig(image_size=64, patch_size=16,
                                  hidden_size=32, num_layers=2, num_heads=4)
    ours = tdino.params_from_dino_state_dict(sd, tconfig)
    theirs = jax.tree.map(np.asarray,
                          jdino.params_from_dino_state_dict(sd, jconfig))
    flat_ours = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_theirs = dict(jax.tree_util.tree_flatten_with_path(theirs)[0])
    assert len(flat_ours) == len(flat_theirs)
    for path, value in flat_ours:
        assert value.dtype == np.float32
        np.testing.assert_array_equal(value, flat_theirs[path])
    # and the module built from it gives the JAX package's maps
    pixels = _pixels(B=1)
    model = tdino.model_from_dino_state_dict(sd, tconfig, device="cpu")
    with torch.inference_mode():
        got = model.last_selfattention(torch.from_numpy(pixels)).numpy()
    np.testing.assert_allclose(got, _jax_maps(theirs, jconfig, pixels,
                                              jnp.float32), atol=1e-5)


def test_maps_are_cls_softmax_rows():
    """Each head's CLS row sums to 1 over all keys: the patch columns hold
    all of it but the CLS->CLS share."""
    config = tdino.DinoViTConfig(**SMALL, num_layers=2)
    model = tdino.init_params(config, torch.Generator().manual_seed(0),
                              device="cpu")
    with torch.inference_mode():
        maps = model.last_selfattention(torch.from_numpy(_pixels())).numpy()
    total = maps.sum(axis=(2, 3))
    assert np.all(total > 0) and np.all(total < 1 + 1e-5)
