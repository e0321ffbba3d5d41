"""marqo_tpu_torch's ConvNeXt-CLIP (models/convnext_clip.py) against
marqo_tpu's.

One open_clip TimmModel-format state dict (the torch mirror of
tests/test_convnext_clip_parity.py, non-trivial ``gamma`` and LayerNorms),
with the linear head (convnext_base*) or the MLP head (convnext_large_d*,
xxlarge), goes through the JAX package's converter; its numpy arrays go to
both packages' forwards (the port's through ``params_from_jax``). The port's
converter must give the same arrays, and both wrappers the same vectors
from one checkpoint on disk. Tolerances: fp32 cosine > 1 - 1e-5 with atol
1e-4 (the reference's own parity bound), bf16 cosine > 1 - 1e-3. No kernel
of the port runs in this tower (convolutions are F.conv2d).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.inference.types import Device as JaxDevice
from marqo_tpu.inference.types import Modality as JaxModality
from marqo_tpu.models import clip as jclip
from marqo_tpu.models import convnext_clip as jcnx
from marqo_tpu_torch.inference.loaders import load_model, resolve_model_class
from marqo_tpu_torch.inference.types import Device, Modality
from marqo_tpu_torch.models import clip as tclip
from marqo_tpu_torch.models import convnext_clip as tcnx
from tests.test_convnext_clip_parity import VisualMirror
from tests.test_torch_resnet_clip import _TextHalf

VISION = dict(depths=(1, 1, 2, 1), dims=(8, 16, 32, 64), image_size=64,
              output_dim=24)
TEXT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, projection_dim=24, eos_token_id=63)
HEADS = ["linear", "mlp"]


def _cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) *
                              np.linalg.norm(b, axis=-1))


def _mirror_state_dict(head, seed=31):
    """The visual mirror's state dict (visual.* keys), LayerNorms and
    biases moved off their init."""
    torch.manual_seed(seed)
    mirror = VisualMirror(jcnx.ConvNextVisionConfig(**VISION),
                          proj=head).eval()
    with torch.no_grad():
        for name, p in mirror.named_parameters():
            if "norm" in name or name.endswith("bias"):
                p.add_(0.1 * torch.randn_like(p))
    return {"visual." + k: v for k, v in mirror.state_dict().items()}


def _shared(head):
    """The JAX layout of the mirror's weights (the JAX package's converter)
    with a CLIP text tower, as jnp arrays, and the port's model from the
    same numpy arrays, fp32 on the CPU."""
    sd_np = {k: v.numpy() for k, v in _mirror_state_dict(head).items()}
    vision = jcnx.convnext_vision_params_from_torch(
        sd_np, jcnx.ConvNextVisionConfig(**VISION), dtype=jnp.float32)
    text = jclip.init_clip_params(
        jclip.CLIPTextConfig(**TEXT),
        jclip.CLIPVisionConfig(image_size=32, patch_size=16, hidden_size=32,
                               num_layers=1, num_heads=2,
                               intermediate_size=64, projection_dim=24),
        jax.random.PRNGKey(0))["text"]
    numpy_params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                                {"text": text, **vision})
    model = tcnx.params_from_jax(numpy_params, tclip.CLIPTextConfig(**TEXT),
                                 tcnx.ConvNextVisionConfig(**VISION),
                                 device="cpu")
    return numpy_params, model


def _pixels(seed=9, B=3):
    return np.random.default_rng(seed).integers(
        0, 256, (B, 64, 64, 3)).astype(np.uint8)


@pytest.mark.parametrize("head", HEADS)
def test_tower_matches_jax(head):
    numpy_params, model = _shared(head)
    assert hasattr(model.vision, "head_fc1") == (head == "mlp")
    pixels = _pixels()
    ref = np.asarray(jcnx.encode_convnext_clip_image(
        jax.tree.map(jnp.asarray, numpy_params), jnp.asarray(pixels),
        jcnx.ConvNextVisionConfig(**VISION), compute_dtype=jnp.float32))
    out = tcnx.encode_convnext_clip_image(model, torch.from_numpy(pixels))
    assert out.dtype == torch.float32 and tuple(out.shape) == (3, 24)
    assert (_cosines(out.numpy(), ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("head", HEADS)
def test_bf16_tower_tracks_jax(head):
    numpy_params, _ = _shared(head)
    model = tcnx.params_from_jax(numpy_params, tclip.CLIPTextConfig(**TEXT),
                                 tcnx.ConvNextVisionConfig(**VISION),
                                 dtype=torch.bfloat16, device="cpu")
    params16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                            numpy_params)
    pixels = _pixels(seed=10)
    ref = np.asarray(jcnx.encode_convnext_clip_image(
        params16, jnp.asarray(pixels), jcnx.ConvNextVisionConfig(**VISION)),
        np.float32)
    out = tcnx.encode_convnext_clip_image(model, torch.from_numpy(pixels))
    assert (_cosines(out.numpy(), ref) > 1 - 1e-3).all()


@pytest.mark.parametrize("head", HEADS)
def test_converter_matches_jax(head):
    sd_np = {k: v.numpy() for k, v in _mirror_state_dict(head).items()}
    ref = jcnx.convnext_vision_params_from_torch(
        sd_np, jcnx.ConvNextVisionConfig(**VISION), dtype=jnp.float32)
    out = tcnx.convnext_vision_params_from_torch(
        sd_np, tcnx.ConvNextVisionConfig(**VISION))
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    out_leaves = dict(jax.tree_util.tree_leaves_with_path(out))
    assert len(ref_leaves) == len(out_leaves)
    for path, value in ref_leaves:
        assert out_leaves[path].dtype == np.float32
        np.testing.assert_array_equal(out_leaves[path], np.asarray(value),
                                      err_msg=str(path))
    assert tcnx.head_hidden(out["vision"]) == (48 if head == "mlp" else 0)


@pytest.fixture(params=HEADS)
def both_wrappers(request, tmp_path, monkeypatch):
    """One open_clip checkpoint (the text half and the visual mirror) and a
    tokenizer on disk, loaded by both packages' wrappers in fp32;
    convnext_base (linear head) or convnext_large_d (MLP head) shrunk to
    the mirror's widths."""
    from marqo_tpu_torch.models.tokenizer import TextTokenizer
    head = request.param
    token = "convnext_base" if head == "linear" else "convnext_large_d"
    torch.manual_seed(5)
    sd = dict(_TextHalf().state_dict())
    sd.update(_mirror_state_dict(head))
    torch.save(sd, str(tmp_path / "open_clip_pytorch_model.bin"))
    TextTokenizer.build_test_wordpiece()._tok.save(
        str(tmp_path / "tokenizer.json"))
    for module in (jcnx, tcnx):
        monkeypatch.setitem(module.CONVNEXT_CONFIGS, token,
                            module.ConvNextVisionConfig(**VISION))
        monkeypatch.setitem(module.CONVNEXT_TEXT, token, (32, 2, 2, 64))
    name = f"open_clip/{token}/laion2b"
    props = {"name": name, "localpath": str(tmp_path)}
    jmodel = jcnx.JaxConvNextCLIPModel(name, props, JaxDevice.CPU)
    jmodel.compute_dtype = jnp.float32
    jmodel.load()
    tmodel = tcnx.TorchConvNextCLIPModel(name, props, Device.CPU)
    tmodel.compute_dtype = torch.float32
    tmodel.load()
    return jmodel, tmodel


def test_wrapper_round_trip_matches_jax(both_wrappers):
    jmodel, tmodel = both_wrappers
    assert tmodel.dimensions == jmodel.dimensions == 24
    assert tmodel.text_config.hidden_act == "gelu"
    texts = ["a photo of a cat", "two dogs", "x"]
    np.testing.assert_allclose(tmodel.encode(texts), jmodel.encode(texts),
                               atol=1e-5)
    images = [np.random.default_rng(i).integers(
        0, 256, size=(70, 50 + 20 * i, 3)).astype(np.uint8)
        for i in range(3)]
    out = tmodel.encode(images, modality=Modality.IMAGE)
    ref = jmodel.encode(images, modality=JaxModality.IMAGE)
    assert (_cosines(out, ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("name", [
    "open_clip/convnext_base/laion400m_s13b_b51k",
    "open_clip/convnext_base_w_320/laion_aesthetic_s13b_b82k",
    "open_clip/convnext_large_d_320/laion2b_s29b_b131k_ft_soup"])
def test_registry_entries_dispatch_and_encode(name):
    from marqo_tpu.inference.loaders import \
        resolve_model_class as jax_resolve
    from marqo_tpu_torch.inference.model_registry import \
        get_model_properties_from_registry
    props = dict(get_model_properties_from_registry(name))
    assert jax_resolve(name, props) is jcnx.JaxConvNextCLIPModel
    assert resolve_model_class(name, props) is tcnx.TorchConvNextCLIPModel
    props.update({"random_init": True, "dimensions": 24, "image_size": 64,
                  "architecture": {"vocab_size": 64}})
    model = load_model(name, props, Device.CPU)
    assert isinstance(model, tcnx.TorchConvNextCLIPModel)
    assert model.encode(["a cat", "two dogs"]).shape == (2, 24)
    out = model.encode([np.zeros((80, 48, 3), np.uint8)],
                       modality=Modality.IMAGE)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)
    gammas = {float(b.gamma.float().abs().max())
              for s in model.encoder.vision.stages for b in s.blocks}
    assert max(gammas) < 1e-5  # the layer scale starts at 1e-6
