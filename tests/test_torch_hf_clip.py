"""marqo_tpu_torch's HF-text CLIP composites (models/hf_clip.py) against
marqo_tpu's: the roberta / xlm-roberta open_clip composites (MLP head) and
M-CLIP (linear head, separate image tower).

The same weights go to both: marqo_tpu's pytree through ``params_from_jax``
(every array perturbed so a dropped bias or misplaced scale shows), or one
checkpoint on disk (tests/test_hf_clip_parity.py's tiny XLM-R + open_clip
ViT) loaded by each package's wrapper. Both run in fp32: text towers agree
within atol 1e-5 (the BERT encoders agree to 1e-5,
tests/test_torch_bert.py), image towers within the fp32 tolerance of
tests/test_torch_clip.py (atol 3e-4, rtol 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.inference.types import Device as JaxDevice
from marqo_tpu.models import bert as jbert
from marqo_tpu.models import clip as jclip
from marqo_tpu.models import hf_clip as jhf
from marqo_tpu_torch.inference.loaders import load_model, resolve_model_class
from marqo_tpu_torch.inference.types import Device, Modality
from marqo_tpu_torch.models import bert as tbert
from marqo_tpu_torch.models import clip as tclip
from marqo_tpu_torch.models import hf_clip as thf
from tests.test_hf_clip_parity import _tiny_roberta, _tiny_vit_sd

TEXT = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=40,
            position_offset=2, pooling="mean", normalize=False)
VISION = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2,
              num_heads=2, intermediate_size=64, projection_dim=24,
              hidden_act="gelu")


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32) + 0.02 *
                                   rng.standard_normal(np.shape(a))
                                   ).astype(np.float32), tree)


@pytest.fixture(scope="module", params=["mlp", "linear"])
def shared(request):
    """The JAX package's composite pytree with an MLP (open_clip) or a
    linear (M-CLIP) head, as numpy, and the port's model built from it."""
    key = jax.random.PRNGKey(0)
    text = jbert.init_params(jbert.TextEncoderConfig(**TEXT), key)
    vision = jclip.init_clip_params(
        jclip.CLIPTextConfig(vocab_size=8, hidden_size=8, num_layers=1,
                             num_heads=2, intermediate_size=16,
                             projection_dim=24),
        jclip.CLIPVisionConfig(**VISION), key)["vision"]
    rng = np.random.default_rng(1)
    if request.param == "mlp":
        head = {"proj_w1": rng.standard_normal((32, 28)) * 0.1,
                "proj_w2": rng.standard_normal((28, 24)) * 0.1}
    else:
        head = {"proj_w": rng.standard_normal((32, 24)) * 0.1,
                "proj_b": rng.standard_normal(24) * 0.1}
    numpy_params = _perturbed({"text": text, "vision": vision, **head}, 2)
    model = thf.params_from_jax(numpy_params, tbert.TextEncoderConfig(**TEXT),
                                tclip.CLIPVisionConfig(**VISION),
                                device="cpu")
    return jax.tree.map(jnp.asarray, numpy_params), model


def _text_inputs(seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 120, size=(4, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 8:] = 0
    mask[2, 3:] = 0
    ids[mask == 0] = 1  # pad token
    return ids, mask


def test_text_tower_matches_jax(shared):
    params, model = shared
    ids, mask = _text_inputs()
    ref = jhf.encode_hf_clip_text_jit(
        params, jnp.asarray(ids), jnp.asarray(mask),
        jbert.TextEncoderConfig(**TEXT), compute_dtype=jnp.float32)
    out = thf.encode_hf_clip_text(model, torch.from_numpy(ids),
                                  torch.from_numpy(mask))
    assert out.dtype == torch.float32 and tuple(out.shape) == (4, 24)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_image_tower_matches_jax(shared):
    params, model = shared
    pixels = np.random.default_rng(4).integers(
        0, 256, size=(3, 32, 32, 3)).astype(np.uint8)
    ref = jclip.encode_clip_image_jit(
        {"vision": params["vision"]}, jnp.asarray(pixels),
        jclip.CLIPVisionConfig(**VISION), compute_dtype=jnp.float32)
    out = thf.encode_hf_clip_image(model, torch.from_numpy(pixels))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-4,
                               rtol=1e-3)


def _tiny_vision(monkeypatch, token):
    """Both packages' ``_VISION[token]`` shrunk to _tiny_vit_sd's tower."""
    monkeypatch.setitem(jhf._VISION, token, jclip.CLIPVisionConfig(**VISION))
    monkeypatch.setitem(thf._VISION, token, tclip.CLIPVisionConfig(**VISION))


def _both_wrappers(name, properties):
    jmodel = jhf.JaxHFCLIPModel(name, properties, JaxDevice.CPU)
    jmodel.compute_dtype = jnp.float32
    jmodel.load()
    tmodel = thf.TorchHFCLIPModel(name, properties, Device.CPU)
    tmodel.compute_dtype = torch.float32
    tmodel.load()
    return jmodel, tmodel


def _save_tokenizer(directory):
    from marqo_tpu_torch.models.tokenizer import TextTokenizer
    TextTokenizer.build_test_wordpiece()._tok.save(
        str(directory / "tokenizer.json"))


def test_open_clip_composite_checkpoint_matches_jax(tmp_path, monkeypatch):
    """One open_clip composite state dict (text.transformer.* XLM-R,
    text.proj MLP, visual.*) through both packages' wrappers."""
    _, roberta = _tiny_roberta()
    torch.manual_seed(2)
    sd = {f"text.transformer.{k}": v for k, v in roberta.state_dict().items()}
    sd["text.proj.0.weight"] = 0.1 * torch.randn(28, 32)
    sd["text.proj.2.weight"] = 0.1 * torch.randn(24, 28)
    sd.update(_tiny_vit_sd())
    torch.save(sd, str(tmp_path / "xlmr_vit_tiny.pt"))
    _save_tokenizer(tmp_path)
    _tiny_vision(monkeypatch, "ViT-B-32")
    name = "open_clip/xlm-roberta-base-ViT-B-32/laion5b_s13b_b90k"
    jmodel, tmodel = _both_wrappers(name, {
        "name": name, "localpath": str(tmp_path / "xlmr_vit_tiny.pt"),
        "dimensions": 24, "architecture": {"text_heads": 2}})
    texts = ["hello world", "a much longer sentence about photos", "x"]
    np.testing.assert_allclose(tmodel.encode(texts), jmodel.encode(texts),
                               atol=1e-5)
    images = [np.random.default_rng(i).integers(
        0, 256, size=(40, 48, 3)).astype(np.uint8) for i in range(2)]
    out = tmodel.encode(images, modality=Modality.IMAGE)
    ref = jmodel.encode(images, modality=jhf.Modality.IMAGE)
    assert out.shape == (2, 24)
    np.testing.assert_allclose(out, ref, atol=3e-4, rtol=1e-3)
    assert tmodel.dimensions == 24
    assert tmodel.memory_bytes() == sum(
        t.numel() * t.element_size() for t in tmodel.encoder.parameters())


def test_mclip_checkpoint_matches_jax(tmp_path, monkeypatch):
    """M-CLIP: transformer.<xlmr> + LinearTransformation text checkpoint,
    the image tower from a separate open_clip-format file."""
    _, roberta = _tiny_roberta(seed=7)
    torch.manual_seed(8)
    lin = torch.nn.Linear(32, 24).eval()
    sd = {f"transformer.{k}": v for k, v in roberta.state_dict().items()}
    sd["LinearTransformation.weight"] = lin.weight.data
    sd["LinearTransformation.bias"] = lin.bias.data
    torch.save(sd, str(tmp_path / "mclip_text.pt"))
    torch.save(_tiny_vit_sd(seed=9), str(tmp_path / "clip_vision.pt"))
    _save_tokenizer(tmp_path)
    _tiny_vision(monkeypatch, "Vit-B/32")
    name = "multilingual-clip/XLM-R Large Vit-B/32"
    jmodel, tmodel = _both_wrappers(name, {
        "name": name, "localpath": str(tmp_path / "mclip_text.pt"),
        "vision_localpath": str(tmp_path / "clip_vision.pt"),
        "dimensions": 24, "architecture": {"text_heads": 2}})
    assert "proj" in tmodel.encoder.head
    texts = ["bonjour le monde", "hallo"]
    np.testing.assert_allclose(tmodel.encode(texts), jmodel.encode(texts),
                               atol=1e-5)
    img = [np.zeros((32, 32, 3), dtype=np.uint8)]
    np.testing.assert_allclose(
        tmodel.encode(img, modality=Modality.IMAGE),
        jmodel.encode(img, modality=jhf.Modality.IMAGE), atol=3e-4,
        rtol=1e-3)


@pytest.mark.parametrize("name", [
    "open_clip/roberta-ViT-B-32/laion2b_s12b_b32k",
    "open_clip/xlm-roberta-base-ViT-B-32/laion5b_s13b_b90k",
    "open_clip/xlm-roberta-large-ViT-H-14/frozen_laion5b_s13b_b90k",
    "multilingual-clip/XLM-R Large Vit-B/32",
])
def test_registry_entries_dispatch_and_encode(name):
    """The registry's HF-text CLIP entries resolve to the port's wrapper,
    as the JAX package's resolve to its own, and a random-init model
    encodes text and images."""
    from marqo_tpu.inference.loaders import \
        resolve_model_class as jax_resolve
    from marqo_tpu_torch.inference.model_registry import \
        get_model_properties_from_registry
    props = dict(get_model_properties_from_registry(name))
    assert jax_resolve(name, props) is jhf.JaxHFCLIPModel
    assert resolve_model_class(name, props) is thf.TorchHFCLIPModel
    props.update({"random_init": True, "dimensions": 24, "image_size": 32,
                  "architecture": {"patch_size": 16, "vocab_size": 64}})
    model = load_model(name, props, Device.CPU)
    assert isinstance(model, thf.TorchHFCLIPModel)
    assert model.encode(["bonjour"]).shape == (1, 24)
    out = model.encode([np.zeros((40, 40, 3), np.uint8)],
                       modality=Modality.IMAGE)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)
