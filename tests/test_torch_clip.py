"""marqo_tpu_torch CLIP (models/clip.py) against the JAX package's towers
and against HF transformers' CLIPModel, at a small size on the CPU.

(a) One parameter set, made by the JAX package's init and carried across
    with ``params_from_jax``: fp32 at tests/test_clip_parity.py's
    tolerances (text atol 2e-4, vision atol 3e-4, rtol 1e-3); bf16 within
    1e-3 cosine. The JAX vision tower pads its 17 tokens to 24 and masks
    the pad keys; the port runs the 17 real tokens unpadded.
(b) EOS pooling at the first EOS, mid-sequence.
(c) The port's HF converter against HF ``get_text_features`` and
    ``get_image_features`` on a random-init CLIPModel.
(d) The open_clip converters give the JAX package's arrays.
(e) The wrapper: text, ndarray, PIL and bytes inputs; unit-norm outputs.
(f) Registry dispatch: the same split as the reference's.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.models import clip as jax_clip
from marqo_tpu_torch.core.exceptions import VectoriseError
from marqo_tpu_torch.inference.types import Device, Modality
from marqo_tpu_torch.models import clip

TEXT = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_positions=16, projection_dim=24,
            eos_token_id=127)
VISION = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=2,
              num_heads=2, intermediate_size=64, projection_dim=24)


def _configs(package):
    return package.CLIPTextConfig(**TEXT), package.CLIPVisionConfig(**VISION)


@pytest.fixture(scope="module")
def shared():
    """JAX params (fp32) and the port's model built from them."""
    text_config, vision_config = _configs(jax_clip)
    params = jax_clip.init_clip_params(text_config, vision_config,
                                       jax.random.PRNGKey(0))
    numpy_params = jax.tree.map(np.asarray, params)
    # init gives zero biases and unit LayerNorms: perturb every array so a
    # dropped bias or a misplaced scale shows
    rng = np.random.default_rng(7)
    numpy_params = jax.tree.map(
        lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32),
        numpy_params)
    params = jax.tree.map(jnp.asarray, numpy_params)
    t_cfg, v_cfg = _configs(clip)
    model = clip.params_from_jax(numpy_params, t_cfg, v_cfg, device="cpu")
    return params, model, numpy_params


def _ids(rng, B, S, eos_at=None):
    ids = rng.integers(1, 126, size=(B, S)).astype(np.int32)
    ids[:, -1 if eos_at is None else eos_at] = 127
    return ids


def _pixels(rng, B):
    return rng.integers(0, 256, size=(B, 32, 32, 3)).astype(np.uint8)


def _cosine(a, b):
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return (a * b).sum(-1)


def test_text_tower_matches_jax_fp32(shared):
    params, model, _ = shared
    ids = _ids(np.random.default_rng(0), 3, 16)
    ref = np.asarray(jax_clip.encode_clip_text(
        params, jnp.asarray(ids), _configs(jax_clip)[0],
        compute_dtype=jnp.float32))
    out = clip.encode_clip_text(model, torch.from_numpy(ids)).numpy()
    assert out.dtype == np.float32 and out.shape == (3, 24)
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-3)


def test_vision_tower_matches_jax_fp32(shared):
    params, model, _ = shared
    pixels = _pixels(np.random.default_rng(1), 3)
    ref = np.asarray(jax_clip.encode_clip_image(
        params, jnp.asarray(pixels), _configs(jax_clip)[1],
        compute_dtype=jnp.float32))
    out = clip.encode_clip_image(model, torch.from_numpy(pixels)).numpy()
    np.testing.assert_allclose(out, ref, atol=3e-4, rtol=1e-3)


def test_towers_match_jax_bf16_in_cosine(shared):
    params, _, numpy_params = shared
    t_cfg, v_cfg = _configs(clip)
    model16 = clip.params_from_jax(numpy_params, t_cfg, v_cfg,
                                   dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(2)
    ids, pixels = _ids(rng, 3, 16), _pixels(rng, 3)
    jt, jv = _configs(jax_clip)
    ref_text = np.asarray(jax_clip.encode_clip_text(
        params, jnp.asarray(ids), jt, compute_dtype=jnp.bfloat16))
    ref_image = np.asarray(jax_clip.encode_clip_image(
        params, jnp.asarray(pixels), jv, compute_dtype=jnp.bfloat16))
    out_text = clip.encode_clip_text(model16, torch.from_numpy(ids))
    out_image = clip.encode_clip_image(model16, torch.from_numpy(pixels))
    assert out_text.dtype == out_image.dtype == torch.float32
    assert np.all(_cosine(out_text.numpy(), ref_text) > 1 - 1e-3)
    assert np.all(_cosine(out_image.numpy(), ref_image) > 1 - 1e-3)


def test_eos_pooling_takes_the_first_eos_mid_sequence(shared):
    params, model, _ = shared
    ids = _ids(np.random.default_rng(3), 2, 16)
    ids[0, 6] = 127  # first EOS mid-sequence, a second one at the end
    ids[1, 9:] = 0
    ids[1, 8] = 127
    ref = np.asarray(jax_clip.encode_clip_text(
        params, jnp.asarray(ids), _configs(jax_clip)[0],
        compute_dtype=jnp.float32))
    out = clip.encode_clip_text(model, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-3)
    # the tokens after the first EOS never reach the pooled output
    changed = ids.copy()
    changed[0, 7:15] = 3
    moved = clip.encode_clip_text(model, torch.from_numpy(changed)).numpy()
    np.testing.assert_allclose(moved[0], out[0], atol=1e-6)


def test_vision_attention_impls_agree_on_the_cpu(shared):
    from dataclasses import replace
    _, model, _ = shared
    pixels = torch.from_numpy(_pixels(np.random.default_rng(4), 2))
    kernel = clip.encode_clip_image(model, pixels)
    config = model.vision.config
    model.vision.config = replace(config, attention_impl="plain")
    try:
        plain = clip.encode_clip_image(model, pixels)
    finally:
        model.vision.config = config
    assert torch.equal(kernel, plain)


# --- HF transformers ---------------------------------------------------------

@pytest.fixture(scope="module")
def hf_pair():
    from transformers import CLIPConfig, CLIPModel
    torch.manual_seed(0)
    hf_config = CLIPConfig(
        text_config={"vocab_size": 128, "hidden_size": 32,
                     "num_hidden_layers": 2, "num_attention_heads": 2,
                     "intermediate_size": 64, "max_position_embeddings": 16,
                     "eos_token_id": 127, "bos_token_id": 126,
                     "pad_token_id": 0},
        vision_config={"image_size": 32, "patch_size": 8, "hidden_size": 32,
                       "num_hidden_layers": 2, "num_attention_heads": 2,
                       "intermediate_size": 64},
        projection_dim=24)
    hf_model = CLIPModel(hf_config).eval()
    t_cfg, v_cfg = _configs(clip)
    model = clip.params_from_jax(
        clip.params_from_hf_clip(hf_model.state_dict(), t_cfg, v_cfg),
        t_cfg, v_cfg, device="cpu")
    return hf_model, model


def test_hf_text_features(hf_pair):
    hf_model, model = hf_pair
    ids = _ids(np.random.default_rng(5), 3, 12)
    ids[0, 5] = 127
    ids[0, 6:] = 0
    with torch.no_grad():
        ref = hf_model.get_text_features(
            input_ids=torch.from_numpy(ids).long())
    ref = getattr(ref, "pooler_output", ref).numpy()
    out = clip.encode_clip_text(model, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-3)


def test_hf_image_features(hf_pair):
    hf_model, model = hf_pair
    pixels = _pixels(np.random.default_rng(6), 2)
    x = pixels.astype(np.float32) / 255.0
    x = (x - np.asarray(clip.CLIP_MEAN)) / np.asarray(clip.CLIP_STD)
    with torch.no_grad():
        ref = hf_model.get_image_features(pixel_values=torch.tensor(
            x.transpose(0, 3, 1, 2), dtype=torch.float32))
    ref = getattr(ref, "pooler_output", ref).numpy()
    out = clip.encode_clip_image(model, torch.from_numpy(pixels)).numpy()
    np.testing.assert_allclose(out, ref, atol=3e-4, rtol=1e-3)


def test_hf_converter_matches_jax_converter(hf_pair):
    hf_model, _ = hf_pair
    sd = hf_model.state_dict()
    ours = clip.params_from_hf_clip(sd, *_configs(clip))
    ref = jax_clip.params_from_hf_clip(sd, *_configs(jax_clip))
    _assert_same_tree(ours, jax.tree.map(np.asarray, ref))


# --- open_clip naming --------------------------------------------------------

def _open_clip_state_dict(seed):
    rng = np.random.default_rng(seed)
    H, I, P, p = 32, 64, 24, 8

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"token_embedding.weight": a(128, H),
          "positional_embedding": a(16, H),
          "ln_final.weight": a(H), "ln_final.bias": a(H),
          "text_projection": a(H, P), "visual.conv1.weight": a(H, 3, p, p),
          "visual.class_embedding": a(H),
          "visual.positional_embedding": a(17, H),
          "visual.ln_pre.weight": a(H), "visual.ln_pre.bias": a(H),
          "visual.ln_post.weight": a(H), "visual.ln_post.bias": a(H),
          "visual.proj": a(H, P)}
    for prefix in ("transformer.resblocks", "visual.transformer.resblocks"):
        for i in range(2):
            base = f"{prefix}.{i}"
            sd.update({
                f"{base}.attn.in_proj_weight": a(3 * H, H),
                f"{base}.attn.in_proj_bias": a(3 * H),
                f"{base}.attn.out_proj.weight": a(H, H),
                f"{base}.attn.out_proj.bias": a(H),
                f"{base}.ln_1.weight": a(H), f"{base}.ln_1.bias": a(H),
                f"{base}.ln_2.weight": a(H), f"{base}.ln_2.bias": a(H),
                f"{base}.mlp.c_fc.weight": a(I, H),
                f"{base}.mlp.c_fc.bias": a(I),
                f"{base}.mlp.c_proj.weight": a(H, I),
                f"{base}.mlp.c_proj.bias": a(H)})
    return sd


def _assert_same_tree(ours, ref):
    assert set(ours) == set(ref)
    for key in ref:
        if isinstance(ref[key], dict):
            _assert_same_tree(ours[key], ref[key])
        else:
            assert ours[key].dtype == np.float32, key
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_open_clip_converters_match_jax():
    sd = _open_clip_state_dict(8)
    ours = clip.params_from_open_clip(sd, *_configs(clip))
    ref = jax_clip.params_from_open_clip(sd, *_configs(jax_clip))
    _assert_same_tree(ours, jax.tree.map(np.asarray, ref))
    blocks = clip.convert_open_clip_resblocks(
        sd, "visual.transformer.resblocks", 2)
    _assert_same_tree(blocks, jax.tree.map(np.asarray, (
        jax_clip.convert_open_clip_resblocks(
            sd, "visual.transformer.resblocks", 2))))
    # the converted arrays load, and torch state dicts convert the same way
    clip.params_from_jax(ours, *_configs(clip), device="cpu")
    from_torch = clip.params_from_open_clip(
        {k: torch.from_numpy(v) for k, v in sd.items()}, *_configs(clip))
    _assert_same_tree(from_torch, ours)


# --- the wrapper -------------------------------------------------------------

@pytest.fixture(scope="module")
def wrapper():
    model = clip.TorchCLIPModel(
        "test-clip", {"type": "clip", "dimensions": 24, "random_init": True,
                      "image_size": 32, "architecture": {"patch_size": 8}},
        Device.CPU)
    model.load()
    return model


def test_wrapper_text_encode(wrapper):
    out = wrapper.encode(["hello world", "goodbye", "x " * 200],
                         modality=Modality.TEXT)
    assert out.shape == (3, 24) and out.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-4)
    assert not np.allclose(out[0], out[1])


def test_wrapper_image_inputs(wrapper, tmp_path):
    from PIL import Image
    rng = np.random.default_rng(0)
    array = rng.integers(0, 256, size=(48, 64, 3)).astype(np.uint8)
    image = Image.fromarray(array)
    buf = io.BytesIO()
    image.save(buf, "PNG")
    path = tmp_path / "img.png"
    image.save(path)
    out = wrapper.encode([array, image, buf.getvalue(), str(path)],
                         modality=Modality.IMAGE)
    assert out.shape == (4, 24)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-4)
    # one image in four forms: one vector
    np.testing.assert_allclose(out, np.broadcast_to(out[0], out.shape),
                               atol=1e-6)
    text = wrapper.encode(["red square"], modality=Modality.TEXT)
    assert text.shape == out[:1].shape


def test_wrapper_refuses_other_modalities(wrapper):
    with pytest.raises(VectoriseError):
        wrapper.encode(["x"], modality=Modality.AUDIO)


def test_wrapper_state(wrapper):
    assert wrapper.loaded and wrapper.dimensions == 24
    params = list(wrapper.encoder.parameters())
    assert {p.device.type for p in params} == {"cpu"}
    assert {p.dtype for p in params} == {torch.bfloat16}
    assert wrapper.memory_bytes() == sum(p.numel() * 2 for p in params)


def test_random_init_is_deterministic_by_name():
    props = {"type": "clip", "dimensions": 24, "random_init": True,
             "image_size": 32, "architecture": {"patch_size": 8}}
    vectors = []
    for name in ("clip-a", "clip-a", "clip-b"):
        model = clip.TorchCLIPModel(name, props, Device.CPU)
        model.load()
        vectors.append(model.encode(["same text"]))
    np.testing.assert_array_equal(vectors[0], vectors[1])
    assert not np.allclose(vectors[0], vectors[2])


# --- registry dispatch -------------------------------------------------------

def _reference_to_port():
    """Each JAX package model class → the port's class for it."""
    from marqo_tpu.inference import loaders as jl
    from marqo_tpu.models.coca import JaxCoCaModel
    from marqo_tpu.models.convnext_clip import JaxConvNextCLIPModel
    from marqo_tpu.models.eva02 import JaxEVA02Model
    from marqo_tpu.models.hf_clip import JaxHFCLIPModel
    from marqo_tpu.models.languagebind import JaxLanguageBindModel
    from marqo_tpu.models.nllb_siglip import JaxNLLBSigLIPModel
    from marqo_tpu.models.resnet_clip import JaxResNetCLIPModel
    from marqo_tpu.models.siglip import JaxSigLIPModel
    from marqo_tpu_torch.inference import loaders as tl
    from marqo_tpu_torch.models.coca import TorchCoCaModel
    from marqo_tpu_torch.models.convnext_clip import TorchConvNextCLIPModel
    from marqo_tpu_torch.models.eva02 import TorchEVA02Model
    from marqo_tpu_torch.models.hf_clip import TorchHFCLIPModel
    from marqo_tpu_torch.models.languagebind import TorchLanguageBindModel
    from marqo_tpu_torch.models.nllb_siglip import TorchNLLBSigLIPModel
    from marqo_tpu_torch.models.resnet_clip import TorchResNetCLIPModel
    from marqo_tpu_torch.models.siglip import TorchSigLIPModel
    return {jl.JaxHFTextModel: tl.TorchHFTextModel,
            jl.JaxStellaModel: tl.TorchStellaModel,
            jl.TestModel: tl.TestModel, jl.RandomModel: tl.RandomModel,
            jl.NoModel: tl.NoModel,
            jax_clip.JaxCLIPModel: clip.TorchCLIPModel,
            JaxHFCLIPModel: TorchHFCLIPModel,
            JaxSigLIPModel: TorchSigLIPModel,
            JaxResNetCLIPModel: TorchResNetCLIPModel,
            JaxConvNextCLIPModel: TorchConvNextCLIPModel,
            JaxNLLBSigLIPModel: TorchNLLBSigLIPModel,
            JaxCoCaModel: TorchCoCaModel,
            JaxEVA02Model: TorchEVA02Model,
            JaxLanguageBindModel: TorchLanguageBindModel}


def test_registry_dispatch_splits_as_the_reference():
    """Every registry entry resolves, in the port, to the counterpart of
    the JAX package's class: all 289 are ported (CoCa 4, EVA02 3 and
    LanguageBind 6 among them) and none is refused."""
    from collections import Counter

    from marqo_tpu.inference.loaders import \
        resolve_model_class as jax_resolve
    from marqo_tpu_torch.inference.loaders import resolve_model_class
    from marqo_tpu_torch.inference.model_registry import load_model_properties
    pairs = _reference_to_port()
    ported, refused, families = 0, [], Counter()
    for name, props in sorted(load_model_properties().items()):
        reference = jax_resolve(name, props)
        if reference not in pairs:
            refused.append(name)
            continue
        assert resolve_model_class(name, props) is pairs[reference], name
        ported += 1
        families[reference.__name__] += 1
    assert refused == []
    assert ported == 289
    assert (families["JaxCoCaModel"], families["JaxEVA02Model"],
            families["JaxLanguageBindModel"]) == (4, 3, 6)
