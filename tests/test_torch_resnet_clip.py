"""marqo_tpu_torch's ResNet-CLIP (models/resnet_clip.py) against marqo_tpu's.

The same weights go to both packages: marqo_tpu's pytree through
``params_from_jax`` (every array perturbed, and the BatchNorm running
statistics drawn at random: the init's mean 0 and var 1 would hide a wrong
fold), or one openai-naming state dict (the torch mirror of
tests/test_resnet_clip_parity.py) through each package's converter and
wrapper. The tower has a stride-2 stage with downsampling and a block
without it. Tolerances: fp32 cosine > 1 - 1e-5 with atol 1e-4 (the
reference's own parity bound), bf16 cosine > 1 - 1e-3. No kernel of the
port runs in this tower (convolutions are F.conv2d).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from marqo_tpu.inference.types import Device as JaxDevice
from marqo_tpu.inference.types import Modality as JaxModality
from marqo_tpu.models import clip as jclip
from marqo_tpu.models import resnet_clip as jres
from marqo_tpu_torch.inference.loaders import load_model, resolve_model_class
from marqo_tpu_torch.inference.types import Device, Modality
from marqo_tpu_torch.models import clip as tclip
from marqo_tpu_torch.models import resnet_clip as tres
from tests.test_resnet_clip_parity import ModifiedResNet

# stage 1: a stride-1 block with a downsampling conv (16 -> 64 channels)
# and one without; stages 2-4: stride 2 with downsampling
VISION = dict(layers=(2, 1, 1, 1), width=16, image_size=64, output_dim=24,
              heads=2)
TEXT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, projection_dim=24, eos_token_id=63)


def _cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) *
                              np.linalg.norm(b, axis=-1))


def _random_stats(tree, rng):
    """Perturb every array; BatchNorm running means ~ N(0, 0.3) and
    variances ~ U(0.3, 2)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: (rng.normal(0, 0.3, np.shape(v)) if k.endswith("_mean")
                        else rng.uniform(0.3, 2.0, np.shape(v))
                        if k.endswith("_var") else walk(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return np.asarray(node, np.float32) + 0.02 * rng.standard_normal(
            np.shape(node))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), walk(tree))


@pytest.fixture(scope="module")
def shared():
    key = jax.random.PRNGKey(0)
    jvision = jres.ResNetVisionConfig(**VISION)
    jtext = jclip.CLIPTextConfig(**TEXT)
    text = jclip.init_clip_params(
        jtext, jclip.CLIPVisionConfig(image_size=32, patch_size=16,
                                      hidden_size=32, num_layers=1,
                                      num_heads=2, intermediate_size=64,
                                      projection_dim=24), key)["text"]
    vision = jres.init_resnet_clip_params(jvision, key)["vision"]
    params = _random_stats({"text": text, "vision": vision},
                           np.random.default_rng(1))
    model = tres.params_from_jax(params, tclip.CLIPTextConfig(**TEXT),
                                 tres.ResNetVisionConfig(**VISION),
                                 device="cpu")
    return jax.tree.map(jnp.asarray, params), params, model, jvision


def _pixels(seed=3, B=3):
    return np.random.default_rng(seed).integers(
        0, 256, (B, 64, 64, 3)).astype(np.uint8)


def test_tower_matches_jax(shared):
    params, _, model, jvision = shared
    pixels = _pixels()
    ref = np.asarray(jres.encode_resnet_clip_image(
        params, jnp.asarray(pixels), jvision, compute_dtype=jnp.float32))
    out = tres.encode_resnet_clip_image(model, torch.from_numpy(pixels))
    assert out.dtype == torch.float32 and tuple(out.shape) == (3, 24)
    assert (_cosines(out.numpy(), ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_tower_layout(shared):
    """A stride-2 stage downsamples; stage 1's second block keeps the
    identity; torch conv weights are (O, I, kh, kw)."""
    _, numpy_params, model, _ = shared
    stages = model.vision.stages
    assert stages[0][0].downsample and stages[0][0].stride == 1
    assert not stages[0][1].downsample
    assert stages[1][0].downsample and stages[1][0].stride == 2
    hwio = numpy_params["vision"]["stages"][1][0]["conv2_w"]
    np.testing.assert_array_equal(stages[1][0].conv2.detach().numpy(),
                                  hwio.transpose(3, 2, 0, 1))


def test_bf16_tower_tracks_jax(shared):
    params, numpy_params, _, jvision = shared
    model = tres.params_from_jax(numpy_params, tclip.CLIPTextConfig(**TEXT),
                                 tres.ResNetVisionConfig(**VISION),
                                 dtype=torch.bfloat16, device="cpu")
    params16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    pixels = _pixels(seed=4)
    ref = np.asarray(jres.encode_resnet_clip_image(
        params16, jnp.asarray(pixels), jvision), np.float32)
    out = tres.encode_resnet_clip_image(model, torch.from_numpy(pixels))
    assert out.dtype == torch.float32
    assert (_cosines(out.numpy(), ref) > 1 - 1e-3).all()


def _mirror(seed=21):
    torch.manual_seed(seed)
    mirror = ModifiedResNet(jres.ResNetVisionConfig(**VISION)).eval()
    with torch.no_grad():
        for module in mirror.modules():
            if isinstance(module, nn.BatchNorm2d):
                module.running_mean.normal_(0, 0.3)
                module.running_var.uniform_(0.3, 2.0)
                module.weight.add_(0.1 * torch.randn_like(module.weight))
                module.bias.normal_(0, 0.1)
    return mirror


def test_converter_matches_jax():
    sd_np = {"visual." + k: v.numpy()
             for k, v in _mirror().state_dict().items()}
    ref = jres.resnet_vision_params_from_torch(
        sd_np, jres.ResNetVisionConfig(**VISION), dtype=jnp.float32)
    out = tres.resnet_vision_params_from_torch(
        sd_np, tres.ResNetVisionConfig(**VISION))
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    out_leaves = dict(jax.tree_util.tree_leaves_with_path(out))
    assert len(ref_leaves) == len(out_leaves)
    for path, value in ref_leaves:
        assert out_leaves[path].dtype == np.float32
        np.testing.assert_array_equal(out_leaves[path], np.asarray(value),
                                      err_msg=str(path))


class _TextHalf(nn.Module):
    """The openai/open_clip text half (as tests/test_resnet_clip_parity.py
    builds it), at the CLIP vocabulary and context."""

    def __init__(self, w=32, L=2, heads=2, mlp=64, embed=24):
        super().__init__()
        self.token_embedding = nn.Embedding(49408, w)
        self.positional_embedding = nn.Parameter(0.02 * torch.randn(77, w))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList()
        for _ in range(L):
            block = nn.Module()
            block.attn = nn.MultiheadAttention(w, heads, batch_first=True)
            block.ln_1, block.ln_2 = nn.LayerNorm(w), nn.LayerNorm(w)
            block.mlp = nn.Sequential()
            block.mlp.add_module("c_fc", nn.Linear(w, mlp))
            block.mlp.add_module("c_proj", nn.Linear(mlp, w))
            self.transformer.resblocks.append(block)
        self.ln_final = nn.LayerNorm(w)
        self.text_projection = nn.Parameter(0.02 * torch.randn(w, embed))


@pytest.fixture
def both_wrappers(tmp_path, monkeypatch):
    """One openai-naming checkpoint (text and vision) and a tokenizer on
    disk, loaded by both packages' wrappers in fp32, RN50 shrunk to the
    mirror's widths."""
    from marqo_tpu_torch.models.tokenizer import TextTokenizer
    torch.manual_seed(3)
    sd = dict(_TextHalf().state_dict())
    sd.update({"visual." + k: v for k, v in _mirror().state_dict().items()})
    torch.save(sd, str(tmp_path / "rn50_tiny.pt"))
    TextTokenizer.build_test_wordpiece()._tok.save(
        str(tmp_path / "tokenizer.json"))
    monkeypatch.setitem(jres.RESNET_CONFIGS, "RN50",
                        jres.ResNetVisionConfig(**VISION))
    monkeypatch.setitem(tres.RESNET_CONFIGS, "RN50",
                        tres.ResNetVisionConfig(**VISION))
    monkeypatch.setitem(jres.JaxResNetCLIPModel._TEXT, "RN50",
                        (32, 2, 2, 64))
    monkeypatch.setitem(tres.TorchResNetCLIPModel._TEXT, "RN50",
                        (32, 2, 2, 64))
    name = "open_clip/RN50/openai"
    props = {"name": name, "localpath": str(tmp_path / "rn50_tiny.pt")}
    jmodel = jres.JaxResNetCLIPModel(name, props, JaxDevice.CPU)
    jmodel.compute_dtype = jnp.float32
    jmodel.load()
    tmodel = tres.TorchResNetCLIPModel(name, props, Device.CPU)
    tmodel.compute_dtype = torch.float32
    tmodel.load()
    return jmodel, tmodel


def test_wrapper_round_trip_matches_jax(both_wrappers):
    jmodel, tmodel = both_wrappers
    assert tmodel.dimensions == jmodel.dimensions == 24
    texts = ["a photo of a cat", "two dogs", "x"]
    np.testing.assert_allclose(tmodel.encode(texts), jmodel.encode(texts),
                               atol=1e-5)
    images = [np.random.default_rng(i).integers(
        0, 256, size=(50 + 10 * i, 80, 3)).astype(np.uint8)
        for i in range(3)]
    out = tmodel.encode(images, modality=Modality.IMAGE)
    ref = jmodel.encode(images, modality=JaxModality.IMAGE)
    assert out.shape == (3, 24)
    assert (_cosines(out, ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert tmodel.memory_bytes() == sum(
        p.numel() * 4 for p in tmodel.encoder.parameters())


@pytest.mark.parametrize("name", ["RN50", "open_clip/RN101-quickgelu/openai",
                                  "onnx16/open_clip/RN50x4/openai"])
def test_registry_entries_dispatch_and_encode(name):
    from marqo_tpu.inference.loaders import \
        resolve_model_class as jax_resolve
    from marqo_tpu_torch.inference.model_registry import \
        get_model_properties_from_registry
    props = dict(get_model_properties_from_registry(name))
    assert jax_resolve(name, props) is jres.JaxResNetCLIPModel
    assert resolve_model_class(name, props) is tres.TorchResNetCLIPModel
    props.update({"random_init": True, "dimensions": 24, "image_size": 64,
                  "architecture": {"width": 16, "vocab_size": 64,
                                   "heads": 2}})
    model = load_model(name, props, Device.CPU)
    assert isinstance(model, tres.TorchResNetCLIPModel)
    out = model.encode(["a cat", "two dogs"])
    assert out.shape == (2, 24)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)
    out = model.encode([np.zeros((80, 48, 3), np.uint8)],
                       modality=Modality.IMAGE)
    assert out.shape == (1, 24) and np.isfinite(out).all()
    assert {p.dtype for p in model.encoder.parameters()} == {torch.bfloat16}
