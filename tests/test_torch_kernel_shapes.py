"""The shapes the port's CUDA kernels take, and the load-time rule for the
ones they do not (ROADMAP C1).

Kernel B1 (ops/flash_attention.py) takes every head dim that is a multiple
of 8 up to 128, as B2 does; kernel B3 (ops/quant_matmul.py) takes K up to
``MAX_K``, and the quantized encoder pads a K that is not a multiple of 16
with zero columns when it loads. ``models/bert.py check_kernel_shapes``
refuses any other head dim or width with ModelLoadError when a model loads
for CUDA, never at a launch. On the CPU the plain twins take any shape, and
the port matches the JAX package there: fp32 cosine > 1 - 1e-5, int8 equal
bit for bit where the JAX package's own int8 layer is.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.models import bert as jbert
from marqo_tpu.ops import quant as jquant
from marqo_tpu_torch.core.exceptions import ModelLoadError
from marqo_tpu_torch.inference.loaders import (TorchHFTextModel,
                                               TorchStellaModel)
from marqo_tpu_torch.inference.types import Device
from marqo_tpu_torch.models import bert as tbert
from marqo_tpu_torch.models.cross_encoder import TorchCrossEncoder
from marqo_tpu_torch.ops import flash_attention as fa
from marqo_tpu_torch.ops import fused_attention as fused
from marqo_tpu_torch.ops import quant_matmul as qm


def _config(hidden, heads, **overrides):
    return tbert.TextEncoderConfig(vocab_size=64, hidden_size=hidden,
                                   num_heads=heads, **overrides)


@pytest.mark.parametrize("hidden,heads,taken", [
    (384, 8, True),      # D = 48: the input of ROADMAP C1
    (768, 12, True), (384, 12, True), (1152, 16, True), (1024, 8, True),
    (40, 2, False),      # D = 20: not a multiple of 8
    (264, 2, False),     # D = 132: over 128
    (100, 3, False),     # the hidden size does not divide by the heads
])
def test_head_dim_rule_is_a_function_of_the_config_and_device(hidden, heads,
                                                              taken):
    config = _config(hidden, heads)
    tbert.check_kernel_shapes(config, "cpu")
    tbert.check_kernel_shapes(replace(config, attention_impl="plain"), "cuda")
    if taken:
        tbert.check_kernel_shapes(config, "cuda")
        tbert.check_kernel_shapes(config, torch.device("cuda"))
        D = hidden // heads
        assert D in fa.HEAD_DIMS and D in fused.HEAD_DIMS
    else:
        with pytest.raises(ModelLoadError, match="head dim"):
            tbert.check_kernel_shapes(config, "cuda")


def test_the_attention_kernels_take_every_multiple_of_8_up_to_128():
    assert fa.HEAD_DIMS == fused.HEAD_DIMS == tuple(range(8, 129, 8))
    for D in (48, 72, 80):
        q = torch.empty(2, 3, 16, D, device="meta")
        fa.check_kernel_inputs(q, q, q, torch.empty(2, 16, dtype=torch.int32,
                                                    device="meta"))


def test_width_rule_for_the_int8_kernel():
    config = _config(768, 12, intermediate_size=5120, quantize=True)
    tbert.check_kernel_shapes(config, "cuda")
    wide = replace(config, intermediate_size=qm.MAX_K + 16)
    with pytest.raises(ModelLoadError, match=f"width {qm.MAX_K + 16}"):
        tbert.check_kernel_shapes(wide, "cuda")
    tbert.check_kernel_shapes(replace(wide, linear_impl="plain"), "cuda")
    tbert.check_kernel_shapes(replace(wide, quantize=False), "cuda")
    tbert.check_kernel_shapes(wide, "cpu")


def _hf_properties(hidden, heads, **extra):
    return {"name": "c1", "type": "hf", "random_init": True,
            "pooling_method": "mean",
            "dimensions": hidden,
            "architecture": {"vocab_size": 64, "hidden_size": hidden,
                             "num_layers": 1, "num_heads": heads,
                             "intermediate_size": 2 * hidden}, **extra}


def test_hf_model_with_head_dim_48_passes_the_cuda_rule():
    """The hf random_init model of ROADMAP C1 (hidden 384, 8 heads) passes
    the rule its loader applies for CUDA before any weights load."""
    model = TorchHFTextModel("c1-d48", _hf_properties(384, 8), Device.CUDA)
    arch = model.properties["architecture"]
    config = model._finalize_config(_config(arch["hidden_size"],
                                            arch["num_heads"]))
    assert config.head_dim == 48


@pytest.mark.parametrize("build", [
    lambda: TorchHFTextModel("c1-d20", _hf_properties(40, 2), Device.CUDA),
    lambda: TorchStellaModel(
        "c1-stella-d20", {"type": "hf_stella", "random_init": True,
                          "dimensions": 16,
                          "architecture": {"hidden_size": 40, "num_heads": 2,
                                           "num_layers": 1,
                                           "intermediate_size": 32}},
        Device.CUDA),
    lambda: TorchCrossEncoder(
        "c1-rerank-d20", Device.CUDA,
        {"random_init": True, "architecture": {"hidden_size": 40,
                                               "num_heads": 2}}),
], ids=["hf", "hf_stella", "cross_encoder"])
def test_loading_refuses_a_head_dim_no_kernel_takes(build):
    """Refused by ModelLoadError when the model loads for CUDA, naming the
    head dim, before anything reaches a device (this host has none)."""
    with pytest.raises(ModelLoadError, match="head dim 20"):
        build().load()


def test_loading_refuses_a_width_the_int8_kernel_does_not_take():
    props = _hf_properties(64, 2, quantize=True)
    props["architecture"]["intermediate_size"] = qm.MAX_K + 16
    with pytest.raises(ModelLoadError, match="int8 kernel"):
        TorchHFTextModel("c1-wide", props, Device.CUDA).load()


def _cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) *
                              np.linalg.norm(b, axis=-1))


def _inputs(B=5, S=24, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, S + 1, B)
    lengths[0] = S
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
    ids = (rng.integers(5, 64, (B, S)) * mask).astype(np.int32)
    return ids, mask


@pytest.mark.parametrize("hidden,heads", [(96, 2), (144, 2), (160, 2)])
def test_encoder_at_new_head_dims_matches_jax(hidden, heads):
    """Head dims 48, 72 and 80 through the port's encoder (B1's padding
    mode; its twin on the CPU) against the JAX package's default einsum
    attention, fp32."""
    overrides = dict(vocab_size=64, hidden_size=hidden, num_layers=2,
                     num_heads=heads, intermediate_size=2 * hidden,
                     max_position_embeddings=32)
    jconfig = jbert.TextEncoderConfig(**overrides)
    params = jbert.init_params(jconfig, jax.random.PRNGKey(hidden))
    encoder = tbert.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params),
        tbert.TextEncoderConfig(**overrides), device="cpu")
    ids, mask = _inputs(seed=hidden)
    ref = jbert.encode_tokens(params, jnp.asarray(ids), jnp.asarray(mask),
                              jconfig, compute_dtype=jnp.float32)
    out = tbert.encode_tokens(encoder, torch.from_numpy(ids),
                              torch.from_numpy(mask)).numpy()
    assert (_cosines(out, ref) > 1 - 1e-5).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [40, 200, 5120])
def test_int8_layer_pads_k_and_equals_the_unpadded_twin(K, dtype):
    """Int8Linear holds K rounded up to 16 with zero columns (40 -> 48, 200
    -> 208; 5120 stays) and pads x to match: the output equals B3's twin
    on the unpadded weights bit for bit."""
    rng = np.random.default_rng(K)
    weight = torch.from_numpy(0.05 * rng.standard_normal((24, K)).astype(
        np.float32)).to(dtype)
    bias = torch.from_numpy(rng.standard_normal(24).astype(np.float32)).to(
        dtype)
    x = torch.from_numpy(rng.standard_normal((3, 7, K)).astype(
        np.float32)).to(dtype)
    layer = tbert.Int8Linear.from_weight(weight, bias)
    assert tuple(layer.weight_q.shape) == (24, tbert.kernel_k(K))
    assert layer.weight_q.shape[1] % 16 == 0
    assert not layer.weight_q[:, K:].any()
    w_q, w_scale = tbert.quantize_weight(weight)
    ref = tbert.int8_linear_reference(x, w_q, w_scale, bias)
    for impl in ("kernel", "plain"):
        assert torch.equal(layer(x, impl), ref)
    qm.check_kernel_inputs(
        torch.empty(21, layer.weight_q.shape[1], dtype=dtype, device="meta"),
        layer.weight_q.to("meta"), layer.weight_scale.to("meta"),
        layer.bias.float().to("meta"))


def test_quantized_encoder_with_ragged_k_matches_jax():
    """intermediate_size 40 (ffn_out's K is not a multiple of 16): the
    port's quantized encoder, from the JAX package's quantized pytree and
    quantizing the fp32 weights itself, against the JAX package's int8
    encoder, fp32."""
    overrides = dict(vocab_size=64, hidden_size=32, num_layers=2,
                     num_heads=2, intermediate_size=40,
                     max_position_embeddings=32)
    jconfig = jbert.TextEncoderConfig(**overrides, quantize=True)
    tconfig = tbert.TextEncoderConfig(**overrides, quantize=True)
    params = jbert.init_params(replace(jconfig, quantize=False),
                               jax.random.PRNGKey(4))
    qparams = jbert.quantize_encoder_params(params)
    ids, mask = _inputs(seed=4)
    ref = jbert.encode_tokens(qparams, jnp.asarray(ids), jnp.asarray(mask),
                              jconfig, compute_dtype=jnp.float32)
    numpy_tree = jax.tree.map(lambda a: np.asarray(a), qparams)
    float_tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    for encoder in (tbert.params_from_jax(numpy_tree, tconfig, device="cpu"),
                    tbert.params_from_jax(float_tree, tconfig,
                                          device="cpu")):
        assert tuple(encoder.layers[0].ffn_out.weight_q.shape) == (32, 48)
        out = tbert.encode_tokens(encoder, torch.from_numpy(ids),
                                  torch.from_numpy(mask)).numpy()
        assert (_cosines(out, ref) > 1 - 1e-5).all()
        np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4)


def test_int8_layer_at_k_5120_equals_jax():
    """The FFN width of ROADMAP C1's input, through the port's Int8Linear
    and the JAX package's int8_linear: equal bit for bit in fp32."""
    rng = np.random.default_rng(5120)
    w = (0.05 * rng.standard_normal((5120, 32))).astype(np.float32)
    x = rng.standard_normal((2, 4, 5120)).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    ref = jquant.int8_linear(jnp.asarray(x), jq, js[0], jnp.asarray(bias),
                             out_dtype=jnp.float32)
    layer = tbert.Int8Linear.from_weight(torch.from_numpy(w.T.copy()),
                                         torch.from_numpy(bias))
    np.testing.assert_array_equal(layer(torch.from_numpy(x)).numpy(),
                                  np.asarray(ref))
