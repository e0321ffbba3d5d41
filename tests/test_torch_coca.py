"""marqo_tpu_torch's CoCa (models/coca.py) against marqo_tpu's.

The open_clip torch mirror of tests/test_coca_parity.py (CoCaMirror: the
appended-CLS text tower with open_clip's left-shifted cls mask, the
attentional pooler with kdim != d_model, the multimodal decoder) gives one
state dict; it goes through each package's converter, and the JAX
package's pytree (every array perturbed, so a dropped bias shows) through
``params_from_jax``. The text tower runs on ragged, zero-padded ids, which
exercise the CLS row. Inputs are made with numpy from a seed. Tolerances:
fp32 cosine > 1 - 1e-5 (with atol 1e-4, the reference's own parity bound;
the decoder's logits 1e-3 as there), bf16 cosine > 1 - 1e-3. On the CPU
the vision blocks' attention is kernel B2's plain twin.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.inference.types import Device as JaxDevice
from marqo_tpu.inference.types import Modality as JaxModality
from marqo_tpu.models import coca as jcoca
from marqo_tpu_torch.core.exceptions import ModelLoadError, VectoriseError
from marqo_tpu_torch.inference.loaders import load_model, resolve_model_class
from marqo_tpu_torch.inference.types import Device, Modality
from marqo_tpu_torch.models import coca as tcoca
from marqo_tpu_torch.ops.image_ops import CLIP_MEAN, CLIP_STD
from tests.test_coca_parity import (DEC, TEXT, VIS, CoCaMirror, _pixels,
                                    _text_ids)


def _port(config):
    """The port's config of the same values as a JAX package config."""
    cls = {jcoca.CoCaTextConfig: tcoca.CoCaTextConfig,
           jcoca.CoCaVisionConfig: tcoca.CoCaVisionConfig,
           jcoca.CoCaDecoderConfig: tcoca.CoCaDecoderConfig}[type(config)]
    return cls(**dataclasses.asdict(config))


CONFIGS = (TEXT, VIS, DEC)
PORT_CONFIGS = tuple(_port(c) for c in CONFIGS)


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32) + 0.02 *
                                   rng.standard_normal(np.shape(a))
                                   ).astype(np.float32), tree)


def _cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) *
                              np.linalg.norm(b, axis=-1))


def _mirror_state_dict(seed=7):
    torch.manual_seed(seed)
    mirror = CoCaMirror().eval()
    with torch.no_grad():  # non-trivial LayerNorms and biases
        for name, p in mirror.named_parameters():
            if name.endswith("bias") or "ln_" in name:
                p.add_(0.05 * torch.randn_like(p))
    return mirror.state_dict()


@pytest.fixture(scope="module")
def shared():
    """The JAX package's params (the mirror's, converted, then perturbed)
    as jnp arrays, and the port's fp32 model from the same numpy arrays."""
    params = _perturbed(jcoca.params_from_open_clip_coca(
        _mirror_state_dict(), *CONFIGS, dtype=jnp.float32), 1)
    model = tcoca.params_from_jax(params, *PORT_CONFIGS, device="cpu")
    return jax.tree.map(jnp.asarray, params), model


def _close(out, ref, atol=1e-4):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    flat = out.reshape(-1, out.shape[-1]), ref.reshape(-1, ref.shape[-1])
    assert (_cosines(*flat) > 1 - 1e-5).all()
    np.testing.assert_allclose(out, ref, atol=atol, rtol=1e-4)


def test_text_tower_with_padding_matches_jax(shared):
    params, model = shared
    ids = _text_ids()  # rows of 12, 9, 5 and 1 real tokens, zero-padded
    ref, ref_tokens = jcoca.encode_coca_text(
        params, jnp.asarray(ids), TEXT, compute_dtype=jnp.float32,
        return_tokens=True)
    out, tokens = tcoca.encode_coca_text(model, torch.from_numpy(ids),
                                         return_tokens=True)
    assert out.dtype == torch.float32 and tuple(out.shape) == (4, 32)
    _close(out.numpy(), ref)
    _close(tokens.numpy(), ref_tokens)


def test_cls_row_follows_the_shifted_non_pad_pattern(shared):
    """The CLS row's mask is part of the contract: a ragged row's latent
    changes when its pad ids become real tokens, in both packages alike,
    and a full row's latent does not move."""
    params, model = shared
    ids = _text_ids()
    filled = np.where(ids == 0, 1, ids).astype(np.int32)
    out = tcoca.encode_coca_text(model, torch.from_numpy(ids)).numpy()
    out_filled = tcoca.encode_coca_text(model,
                                        torch.from_numpy(filled)).numpy()
    ref_filled = np.asarray(jcoca.encode_coca_text(
        params, jnp.asarray(filled), TEXT, compute_dtype=jnp.float32))
    _close(out_filled, ref_filled)
    np.testing.assert_allclose(out[0], out_filled[0], atol=1e-6)
    assert not np.allclose(out[2], out_filled[2], atol=1e-4)


def test_vision_tower_with_pooler_matches_jax(shared):
    params, model = shared
    pixels = _pixels()
    ref, ref_tokens = jcoca.encode_coca_image(
        params, jnp.asarray(pixels), VIS, compute_dtype=jnp.float32,
        return_tokens=True)
    out, tokens = tcoca.encode_coca_image(model, torch.from_numpy(pixels),
                                          return_tokens=True)
    assert tuple(tokens.shape) == (3, VIS.n_queries - 1, VIS.embed_dim)
    _close(out.numpy(), ref)
    _close(tokens.numpy(), ref_tokens)


def test_decoder_logits_match_jax(shared):
    params, model = shared
    ids, pixels = _text_ids()[:3], _pixels()
    _, jt = jcoca.encode_coca_text(params, jnp.asarray(ids), TEXT,
                                   compute_dtype=jnp.float32,
                                   return_tokens=True)
    _, ji = jcoca.encode_coca_image(params, jnp.asarray(pixels), VIS,
                                    compute_dtype=jnp.float32,
                                    return_tokens=True)
    ref = jcoca.coca_decode_logits(params, jt, ji, DEC,
                                   compute_dtype=jnp.float32)
    out = tcoca.coca_decode_logits(
        model, torch.from_numpy(np.array(jt)), torch.from_numpy(np.array(ji)))
    assert out.dtype == torch.float32
    _close(out.numpy(), ref, atol=1e-3)


def test_port_matches_the_open_clip_mirror():
    """The port's own converter and towers against the torch mirror."""
    sd = _mirror_state_dict(seed=9)
    torch.manual_seed(9)
    mirror = CoCaMirror().eval()
    mirror.load_state_dict(sd)
    model = tcoca.params_from_jax(
        tcoca.params_from_open_clip_coca(sd, *PORT_CONFIGS), *PORT_CONFIGS,
        device="cpu")
    ids, u8 = _text_ids()[:3], _pixels()
    x = (u8.astype(np.float32) / 255.0 - np.asarray(CLIP_MEAN)) / \
        np.asarray(CLIP_STD)
    with torch.no_grad():
        ref, ref_tokens = mirror.text(torch.from_numpy(ids).long())
        ref_image, ref_image_tokens = mirror.visual(
            torch.from_numpy(x.transpose(0, 3, 1, 2)).float())
        ref_logits = mirror.text_decoder(ref_image_tokens, ref_tokens)
        out, tokens = tcoca.encode_coca_text(model, torch.from_numpy(ids),
                                             return_tokens=True)
        image, image_tokens = tcoca.encode_coca_image(
            model, torch.from_numpy(u8), return_tokens=True)
        logits = tcoca.coca_decode_logits(model, tokens, image_tokens)
    _close(out.numpy(), ref.numpy())
    _close(image.numpy(), ref_image.numpy())
    _close(logits.numpy(), ref_logits.numpy(), atol=1e-3)


def test_bf16_towers_track_jax(shared):
    params, _ = shared
    model = tcoca.params_from_jax(jax.tree.map(np.asarray, params),
                                  *PORT_CONFIGS, dtype=torch.bfloat16,
                                  device="cpu")
    params16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    ids, pixels = _text_ids(), _pixels()
    for ref, out in (
            (jcoca.encode_coca_text(params16, jnp.asarray(ids), TEXT),
             tcoca.encode_coca_text(model, torch.from_numpy(ids))),
            (jcoca.encode_coca_image(params16, jnp.asarray(pixels), VIS),
             tcoca.encode_coca_image(model, torch.from_numpy(pixels)))):
        assert out.dtype == torch.float32
        assert (_cosines(out.numpy(), np.asarray(ref, np.float32))
                > 1 - 1e-3).all()


def test_converter_matches_jax():
    sd = _mirror_state_dict(seed=11)
    ref = jcoca.params_from_open_clip_coca(sd, *CONFIGS, dtype=jnp.float32)
    out = tcoca.params_from_open_clip_coca(sd, *PORT_CONFIGS)
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    out_leaves = dict(jax.tree_util.tree_leaves_with_path(out))
    assert len(ref_leaves) == len(out_leaves)
    for path, value in ref_leaves:
        assert out_leaves[path].dtype == np.float32
        np.testing.assert_array_equal(out_leaves[path], np.asarray(value),
                                      err_msg=str(path))


# --- the wrapper ---------------------------------------------------------------

@pytest.fixture
def both_wrappers(tmp_path, monkeypatch):
    """The mirror's checkpoint (and a tokenizer beside it) loaded by both
    packages' wrappers in fp32, the coca_ViT-B-32 configs at the mirror's
    widths."""
    from marqo_tpu_torch.models.tokenizer import TextTokenizer
    torch.save(_mirror_state_dict(seed=13), str(tmp_path / "coca.pt"))
    TextTokenizer.build_test_wordpiece()._tok.save(
        str(tmp_path / "tokenizer.json"))
    monkeypatch.setattr(jcoca, "coca_vit_b32_configs",
                        lambda embed_dim: CONFIGS)
    monkeypatch.setattr(tcoca, "coca_vit_b32_configs",
                        lambda embed_dim: PORT_CONFIGS)
    name = "open_clip/coca_ViT-B-32/laion2b_s13b_b90k"
    props = {"name": name, "localpath": str(tmp_path / "coca.pt"),
             "dimensions": 32}
    jmodel = jcoca.JaxCoCaModel(name, props, JaxDevice.CPU)
    jmodel.compute_dtype = jnp.float32
    jmodel.load()
    tmodel = tcoca.TorchCoCaModel(name, props, Device.CPU)
    tmodel.compute_dtype = torch.float32
    tmodel.load()
    return jmodel, tmodel


IMAGES = [np.random.default_rng(i).integers(
    0, 256, size=(40 + 8 * i, 48, 3)).astype(np.uint8) for i in range(3)]


def test_wrapper_encodes_as_jax(both_wrappers):
    jmodel, tmodel = both_wrappers
    texts = ["a cat on a mat", "two dogs playing", "x"]
    out = tmodel.encode(texts)
    assert out.shape == (3, 32) and tmodel.dimensions == 32
    np.testing.assert_allclose(out, jmodel.encode(texts), atol=1e-5)
    out = tmodel.encode(IMAGES, modality=Modality.IMAGE)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(
        out, jmodel.encode(IMAGES, modality=JaxModality.IMAGE), atol=1e-4)
    with pytest.raises(VectoriseError):
        tmodel.encode(["x"], modality=Modality.AUDIO)


def test_caption_logits_match_jax(both_wrappers):
    jmodel, tmodel = both_wrappers
    texts = ["a red car", "two birds on a wire", "snow"]
    out = tmodel.caption_logits(texts, IMAGES)
    ref = jmodel.caption_logits(texts, IMAGES)
    assert out.shape == (3, TEXT.context_length, TEXT.vocab_size)
    _close(out, ref, atol=1e-3)


@pytest.mark.parametrize("eos_id", [None, 7])
def test_greedy_caption_ids_equal_jax(both_wrappers, eos_id):
    """The same host loop with the same stopping rules: equal ids in fp32
    (with an eos id, finished rows keep emitting it)."""
    jmodel, tmodel = both_wrappers
    kwargs = dict(max_len=6, sot_id=1, eos_id=eos_id)
    out = tmodel.generate_caption_ids(IMAGES, **kwargs)
    assert out == jmodel.generate_caption_ids(IMAGES, **kwargs)
    assert len(out) == 3 and all(c[0] == 1 and len(c) <= 6 for c in out)


def test_generation_stops_at_the_context_length(both_wrappers):
    """The JAX package's rule: stop once the prefix would pass the text
    tower's context length, whatever max_len asks."""
    _, tmodel = both_wrappers
    out = tmodel.generate_caption_ids(IMAGES[:1], max_len=40)
    assert len(out[0]) == TEXT.context_length


def test_load_without_checkpoint_or_random_init_is_refused():
    with pytest.raises(ModelLoadError, match="requires an open_clip"):
        tcoca.TorchCoCaModel("coca", {}, Device.CPU).load()


@pytest.mark.parametrize("name", [
    "open_clip/coca_ViT-B-32/laion2b_s13b_b90k",
    "open_clip/coca_ViT-L-14/laion2b_s13b_b90k",
    "open_clip/coca_ViT-B-32/mscoco_finetuned_laion2b_s13b_b90k",
    "open_clip/coca_ViT-L-14/mscoco_finetuned_laion2b_s13b_b90k",
])
def test_registry_entries_dispatch_and_encode(name):
    """CoCa registry entries resolve to the port's wrapper as the JAX
    package's resolve to its own; a random-init bf16 model encodes text
    and images, gives caption logits and greedy ids."""
    from marqo_tpu.inference.loaders import \
        resolve_model_class as jax_resolve
    from marqo_tpu_torch.inference.model_registry import \
        get_model_properties_from_registry
    props = dict(get_model_properties_from_registry(name))
    assert jax_resolve(name, props) is jcoca.JaxCoCaModel
    assert resolve_model_class(name, props) is tcoca.TorchCoCaModel
    props.update({"random_init": True, "dimensions": 16, "image_size": 32,
                  "architecture": {"patch_size": 16, "vocab_size": 64,
                                   "context_length": 12}})
    model = load_model(name, props, Device.CPU)
    assert isinstance(model, tcoca.TorchCoCaModel)
    assert model.encode(["a cat", "two dogs"]).shape == (2, 16)
    image = np.zeros((32, 32, 3), np.uint8)
    out = model.encode([image], modality=Modality.IMAGE)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)
    assert model.caption_logits(["a cat"], [image]).shape == (1, 12, 64)
    caps = model.generate_caption_ids([image, image + 255], max_len=6)
    assert len(caps) == 2 and all(c[0] == 1 and 2 <= len(c) <= 6
                                  for c in caps)
    assert {p.dtype for p in model.encoder.parameters()} == {torch.bfloat16}
