"""marqo_tpu_torch's SigLIP (models/siglip.py) against marqo_tpu's.

The same weights go to both packages: marqo_tpu's pytree through
``params_from_jax`` (every array perturbed, so a dropped bias or a
misplaced LayerNorm shows), or one open_clip-format state dict (the torch
mirror of tests/test_siglip_parity.py) through each package's converter and
wrapper. Inputs are made with numpy from a seed. Tolerances: fp32 cosine >
1 - 1e-5 (with atol 1e-4, the reference's own parity bound), bf16 cosine >
1 - 1e-3. On the CPU the blocks' attention is kernel B2's plain twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from marqo_tpu.inference.types import Device as JaxDevice
from marqo_tpu.inference.types import Modality as JaxModality
from marqo_tpu.models import siglip as jsig
from marqo_tpu_torch.inference.loaders import load_model, resolve_model_class
from marqo_tpu_torch.inference.types import Device, Modality
from marqo_tpu_torch.models import siglip as tsig
from tests.test_siglip_parity import TextTower, VisionTrunk

TEXT = dict(vocab_size=60, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, context_length=10, embed_dim=24)
VISION = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2,
              num_heads=2, intermediate_size=64)
# 64 px at patch 14: a 4 x 4 grid over the first 56 px (as SO400M-14 at
# 384 px takes 27 x 27 over 378)
VISION_RAGGED = dict(VISION, image_size=64, patch_size=14)


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32) + 0.02 *
                                   rng.standard_normal(np.shape(a))
                                   ).astype(np.float32), tree)


def _cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) *
                              np.linalg.norm(b, axis=-1))


def _shared(vision, seed=0, layers=None):
    """The JAX package's perturbed params (as jnp arrays) and the port's
    model built from the same numpy arrays, fp32 on the CPU."""
    vision = dict(vision, num_layers=vision["num_layers"] if layers is None
                  else layers)
    jtext, jvision = jsig.SigLIPTextConfig(**TEXT), \
        jsig.SigLIPVisionConfig(**vision)
    params = _perturbed(jsig.init_siglip_params(
        jtext, jvision, jax.random.PRNGKey(seed)), seed + 1)
    model = tsig.params_from_jax(params, tsig.SigLIPTextConfig(**TEXT),
                                 tsig.SigLIPVisionConfig(**vision),
                                 device="cpu")
    return jax.tree.map(jnp.asarray, params), model, jtext, jvision


@pytest.fixture(scope="module")
def shared():
    return _shared(VISION)


def _ids(seed=3, B=4):
    return np.random.default_rng(seed).integers(
        0, TEXT["vocab_size"], (B, TEXT["context_length"])).astype(np.int32)


def _pixels(size, seed=4, B=3):
    return np.random.default_rng(seed).integers(
        0, 256, (B, size, size, 3)).astype(np.uint8)


def test_text_tower_matches_jax(shared):
    params, model, jtext, _ = shared
    ids = _ids()
    ref = np.asarray(jsig.encode_siglip_text(params, jnp.asarray(ids), jtext,
                                             compute_dtype=jnp.float32))
    out = tsig.encode_siglip_text(model, torch.from_numpy(ids))
    assert out.dtype == torch.float32 and tuple(out.shape) == (4, 24)
    assert (_cosines(out.numpy(), ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("vision", [VISION, VISION_RAGGED],
                         ids=["32px_patch16", "64px_patch14"])
def test_vision_tower_matches_jax(vision):
    params, model, _, jvision = _shared(vision, seed=5)
    pixels = _pixels(vision["image_size"])
    ref = np.asarray(jsig.encode_siglip_image(
        params, jnp.asarray(pixels), jvision, compute_dtype=jnp.float32))
    out = tsig.encode_siglip_image(model, torch.from_numpy(pixels))
    assert tuple(out.shape) == (3, 32)
    assert (_cosines(out.numpy(), ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_latent_pool_matches_jax():
    """No blocks: the patch embedding, the final LayerNorm and the latent
    attention pool alone carry the image to its vector."""
    params, model, _, jvision = _shared(VISION, seed=7, layers=0)
    pixels = _pixels(32, seed=8)
    ref = np.asarray(jsig.encode_siglip_image(
        params, jnp.asarray(pixels), jvision, compute_dtype=jnp.float32))
    out = tsig.encode_siglip_image(model, torch.from_numpy(pixels)).numpy()
    assert (_cosines(out, ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_bf16_towers_track_jax(shared):
    params, _, jtext, jvision = shared
    numpy_params = jax.tree.map(np.asarray, params)
    model = tsig.params_from_jax(numpy_params, tsig.SigLIPTextConfig(**TEXT),
                                 tsig.SigLIPVisionConfig(**VISION),
                                 dtype=torch.bfloat16, device="cpu")
    params16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    ids, pixels = _ids(seed=9), _pixels(32, seed=10)
    for ref, out in (
            (jsig.encode_siglip_text(params16, jnp.asarray(ids), jtext),
             tsig.encode_siglip_text(model, torch.from_numpy(ids))),
            (jsig.encode_siglip_image(params16, jnp.asarray(pixels), jvision),
             tsig.encode_siglip_image(model, torch.from_numpy(pixels)))):
        assert out.dtype == torch.float32
        assert (_cosines(out.numpy(), np.asarray(ref, np.float32))
                > 1 - 1e-3).all()


def test_plain_attention_impl_is_the_twin_on_cpu(shared):
    _, model, _, _ = shared
    ids = torch.from_numpy(_ids(seed=11))
    kernel = tsig.encode_siglip_text(model, ids)
    wrapper = tsig.TorchSigLIPModel("x", {}, Device.CPU)
    wrapper.encoder = model
    wrapper.set_attention_impl("plain")
    try:
        assert model.text.config.attention_impl == "plain"
        assert torch.equal(tsig.encode_siglip_text(model, ids), kernel)
    finally:
        wrapper.set_attention_impl("kernel")


# --- the converter and the wrapper ------------------------------------------

CKPT_TEXT = dict(TEXT, vocab_size=32000, context_length=64, embed_dim=32)


class _Mirror(nn.Module):
    """tests/test_siglip_parity.py's open_clip/timm mirror at the widths the
    wrappers give the monkeypatched "ViT-B-16-SigLIP" token."""

    def __init__(self, text, vision):
        super().__init__()
        self.text = TextTower(text)
        self.visual = nn.Module()
        self.visual.trunk = VisionTrunk(vision)


def _mirror_state_dict(seed=12):
    torch.manual_seed(seed)
    mirror = _Mirror(jsig.SigLIPTextConfig(**CKPT_TEXT),
                     jsig.SigLIPVisionConfig(**VISION)).eval()
    with torch.no_grad():  # non-trivial LayerNorms and biases
        for name, p in mirror.named_parameters():
            if name.endswith("bias") or "norm" in name or "ln_" in name:
                p.add_(0.05 * torch.randn_like(p))
    return mirror.state_dict()


def test_converter_matches_jax():
    sd = _mirror_state_dict()
    ref = jsig.params_from_open_clip_siglip(
        sd, jsig.SigLIPTextConfig(**CKPT_TEXT),
        jsig.SigLIPVisionConfig(**VISION), dtype=jnp.float32)
    out = tsig.params_from_open_clip_siglip(
        sd, tsig.SigLIPTextConfig(**CKPT_TEXT),
        tsig.SigLIPVisionConfig(**VISION))
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    out_leaves = dict(jax.tree_util.tree_leaves_with_path(out))
    assert len(ref_leaves) == len(out_leaves)
    for path, value in ref_leaves:
        assert out_leaves[path].dtype == np.float32
        np.testing.assert_array_equal(out_leaves[path], np.asarray(value),
                                      err_msg=str(path))
    vision_only = tsig.params_from_open_clip_siglip(
        sd, None, tsig.SigLIPVisionConfig(**VISION), vision_only=True)
    assert vision_only["text"] is None


def _tiny_arch(monkeypatch):
    """Both packages' "ViT-B-16-SigLIP" token at the mirror's widths."""
    arch = ((32, 2, 2, 64, 16), (32, 2, 2, 64))
    monkeypatch.setitem(jsig._SIGLIP_ARCHS, "ViT-B-16-SigLIP", arch)
    monkeypatch.setitem(tsig._SIGLIP_ARCHS, "ViT-B-16-SigLIP", arch)


@pytest.fixture
def both_wrappers(tmp_path, monkeypatch):
    """One checkpoint on disk (the mirror's state dict and a tokenizer)
    loaded by both packages' wrappers, fp32."""
    from marqo_tpu_torch.models.tokenizer import TextTokenizer
    torch.save(_mirror_state_dict(), str(tmp_path / "open_clip_model.pt"))
    TextTokenizer.build_test_wordpiece()._tok.save(
        str(tmp_path / "tokenizer.json"))
    _tiny_arch(monkeypatch)
    name = "Marqo/marqo-fashionSigLIP"
    props = {"name": "hf-hub:Marqo/marqo-fashionSigLIP ViT-B-16-SigLIP",
             "localpath": str(tmp_path / "open_clip_model.pt"),
             "image_size": 32}
    jmodel = jsig.JaxSigLIPModel(name, props, JaxDevice.CPU)
    jmodel.compute_dtype = jnp.float32
    jmodel.load()
    tmodel = tsig.TorchSigLIPModel(name, props, Device.CPU)
    tmodel.compute_dtype = torch.float32
    tmodel.load()
    return jmodel, tmodel


def test_wrapper_encodes_text_as_jax(both_wrappers):
    jmodel, tmodel = both_wrappers
    texts = ["a red dress", "two shoes on a shelf", "x"]
    out = tmodel.encode(texts)
    assert out.shape == (3, 32) and tmodel.dimensions == 32
    np.testing.assert_allclose(out, jmodel.encode(texts), atol=1e-5)


def test_wrapper_encodes_images_as_jax(both_wrappers):
    jmodel, tmodel = both_wrappers
    images = [np.random.default_rng(i).integers(
        0, 256, size=(40 + 8 * i, 48, 3)).astype(np.uint8) for i in range(3)]
    out = tmodel.encode(images, modality=Modality.IMAGE)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(
        out, jmodel.encode(images, modality=JaxModality.IMAGE), atol=1e-4)
    assert tmodel.memory_bytes() == sum(
        p.numel() * 4 for p in tmodel.encoder.parameters())


def test_preprocessing_is_byte_equal_to_jax(both_wrappers):
    """A square bicubic resize with no crop, in uint8 on the host."""
    jmodel, tmodel = both_wrappers
    for shape in ((40, 24, 3), (17, 90, 3), (32, 32, 3)):
        image = np.random.default_rng(sum(shape)).integers(
            0, 256, size=shape).astype(np.uint8)
        out = tmodel._preprocess_host(image)
        assert out.shape == (32, 32, 3) and out.dtype == np.uint8
        np.testing.assert_array_equal(out, jmodel._preprocess_host(image))


def test_wrapper_refuses_other_modalities(both_wrappers):
    from marqo_tpu_torch.core.exceptions import VectoriseError
    with pytest.raises(VectoriseError):
        both_wrappers[1].encode(["x"], modality=Modality.AUDIO)


@pytest.mark.parametrize("name", [
    "open_clip/ViT-B-16-SigLIP/webli",
    "open_clip/ViT-SO400M-14-SigLIP-384/webli",
    "Marqo/marqo-fashionSigLIP",
])
def test_registry_entries_dispatch_and_encode(name):
    """SigLIP registry entries resolve to the port's wrapper as the JAX
    package's resolve to its own, and a random-init model encodes text and
    images (64 px at patch 14 drops the remainder)."""
    from marqo_tpu.inference.loaders import \
        resolve_model_class as jax_resolve
    from marqo_tpu_torch.inference.model_registry import \
        get_model_properties_from_registry
    props = dict(get_model_properties_from_registry(name))
    assert jax_resolve(name, props) is jsig.JaxSigLIPModel
    assert resolve_model_class(name, props) is tsig.TorchSigLIPModel
    props.update({"random_init": True, "dimensions": 32, "image_size": 64,
                  "architecture": {"patch_size": 14, "vocab_size": 64}})
    model = load_model(name, props, Device.CPU)
    assert isinstance(model, tsig.TorchSigLIPModel)
    assert model.encode(["hello", "two dogs"]).shape == (2, 32)
    out = model.encode([np.zeros((40, 24, 3), np.uint8)],
                       modality=Modality.IMAGE)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)
    assert {p.dtype for p in model.encoder.parameters()} == {torch.bfloat16}
