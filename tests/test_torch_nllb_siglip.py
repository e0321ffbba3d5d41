"""marqo_tpu_torch's NLLB-SigLIP (models/nllb_siglip.py) against marqo_tpu's.

The text tower (M2M-100: scaled embeddings, fairseq sinusoidal positions,
pre-LN layers with padding-masked attention, first-token pooling) gets the
JAX package's perturbed params through ``params_from_jax`` and rows of
different lengths, so the padding is real; on the CPU its attention is
kernel B1's padding-mode twin. The converter is held against the JAX
package's on a transformers M2M100 encoder, and both wrappers against each
other on one open_clip-pairing checkpoint, behind the same
MARQO_ALLOW_UNVERIFIED_CONVERSION gate. Tolerances: fp32 cosine > 1 - 1e-5
with atol 1e-4, bf16 cosine > 1 - 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.core.exceptions import ModelLoadError as JaxModelLoadError
from marqo_tpu.inference.types import Device as JaxDevice
from marqo_tpu.inference.types import Modality as JaxModality
from marqo_tpu.models import nllb_siglip as jnllb
from marqo_tpu.models import siglip as jsig
from marqo_tpu_torch.core.exceptions import ModelLoadError
from marqo_tpu_torch.inference.loaders import load_model, resolve_model_class
from marqo_tpu_torch.inference.types import Device, Modality
from marqo_tpu_torch.models import nllb_siglip as tnllb
from marqo_tpu_torch.models import siglip as tsig
from tests.test_siglip_parity import VisionTrunk

TEXT = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_positions=64, embed_dim=24)
VISION = dict(image_size=32, patch_size=16, hidden_size=24, num_layers=2,
              num_heads=2, intermediate_size=48)


def _cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) *
                              np.linalg.norm(b, axis=-1))


@pytest.fixture(scope="module")
def shared():
    """The JAX package's text and vision params, every array perturbed,
    as numpy; the port's model built from them, fp32 on the CPU."""
    rng = np.random.default_rng(1)
    text = jnllb.init_nllb_text_params(jnllb.NLLBTextConfig(**TEXT),
                                       jax.random.PRNGKey(0))
    vision = jsig.init_siglip_params(
        jsig.SigLIPTextConfig(vocab_size=8, hidden_size=8, num_layers=1,
                              num_heads=1, intermediate_size=8),
        jsig.SigLIPVisionConfig(**VISION), jax.random.PRNGKey(1))["vision"]

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        if "position_table" in jax.tree_util.keystr(path):
            return a  # the fixed sinusoidal table
        return (a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(
        perturb, {"text": text, "vision": vision})
    model = tnllb.params_from_jax(params, tnllb.NLLBTextConfig(**TEXT),
                                  tsig.SigLIPVisionConfig(**VISION),
                                  device="cpu")
    return params, model


def _padded_ids(seed=0):
    """Rows of 10, 7, 4 and 1 real tokens; pad id 1 after them."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, TEXT["vocab_size"], (4, 10)).astype(np.int32)
    for row, length in enumerate((10, 7, 4, 1)):
        ids[row, length:] = 1
    return ids


def test_text_tower_with_padding_matches_jax(shared):
    params, model = shared
    ids = _padded_ids()
    ref = np.asarray(jnllb.encode_nllb_text(
        jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
        jnllb.NLLBTextConfig(**TEXT), compute_dtype=jnp.float32))
    out = tnllb.encode_nllb_text(model, torch.from_numpy(ids))
    assert out.dtype == torch.float32 and tuple(out.shape) == (4, 24)
    assert (_cosines(out.numpy(), ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_padding_leaves_the_pooled_vector_unchanged(shared):
    """Extra pad columns change neither the positions nor the attended
    keys of the real tokens."""
    _, model = shared
    ids = _padded_ids(seed=2)
    wider = np.full((4, 16), 1, np.int32)
    wider[:, :10] = ids
    short, long = (tnllb.encode_nllb_text(model, torch.from_numpy(a))
                   for a in (ids, wider))
    np.testing.assert_allclose(short.numpy(), long.numpy(), atol=1e-5)


def test_bf16_text_tower_tracks_jax(shared):
    params, _ = shared
    model = tnllb.params_from_jax(params, tnllb.NLLBTextConfig(**TEXT),
                                  tsig.SigLIPVisionConfig(**VISION),
                                  dtype=torch.bfloat16, device="cpu")
    assert model.text.position_table.dtype == torch.float32
    assert model.text.token_embedding.dtype == torch.bfloat16
    params16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    params16["text"]["position_table"] = jnp.asarray(
        params["text"]["position_table"])
    ids = _padded_ids(seed=3)
    ref = np.asarray(jnllb.encode_nllb_text(
        params16, jnp.asarray(ids), jnllb.NLLBTextConfig(**TEXT)), np.float32)
    out = tnllb.encode_nllb_text(model, torch.from_numpy(ids))
    assert (_cosines(out.numpy(), ref) > 1 - 1e-3).all()


def test_vision_tower_matches_jax(shared):
    params, model = shared
    pixels = np.random.default_rng(4).integers(
        0, 256, (2, 32, 32, 3)).astype(np.uint8)
    ref = np.asarray(jsig.encode_siglip_image(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pixels),
        jsig.SigLIPVisionConfig(**VISION), compute_dtype=jnp.float32))
    out = tnllb.encode_nllb_image(model, torch.from_numpy(pixels)).numpy()
    assert (_cosines(out, ref) > 1 - 1e-5).all()


@pytest.mark.parametrize("n,dim,pad", [(66, 32, 1), (18, 8, 1), (10, 7, 0),
                                       (1026, 1024, 1)])
def test_sinusoidal_table_matches_jax(n, dim, pad):
    out = tnllb.sinusoidal_positions(n, dim, pad)
    assert out.dtype == np.float32 and out.shape == (n, dim)
    np.testing.assert_array_equal(out, jnllb.sinusoidal_positions(n, dim,
                                                                  pad))
    assert not out[pad].any()


def _m2m100_encoder_state(seed=0):
    from transformers import M2M100Config, M2M100Model
    hf_config = M2M100Config(
        vocab_size=TEXT["vocab_size"], d_model=32, encoder_layers=2,
        decoder_layers=1, encoder_attention_heads=4,
        decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
        max_position_embeddings=64, scale_embedding=True, pad_token_id=1)
    torch.manual_seed(seed)
    return M2M100Model(hf_config).eval().state_dict()


def test_text_converter_matches_jax():
    sd = _m2m100_encoder_state()
    proj = (np.random.default_rng(5).standard_normal((32, 24)),
            np.random.default_rng(6).standard_normal(24))
    for projection in (None, proj):
        ref = jnllb.params_from_m2m100_encoder(
            sd, jnllb.NLLBTextConfig(**TEXT), prefix="encoder.",
            proj=projection, dtype=jnp.float32)
        out = tnllb.params_from_m2m100_encoder(
            sd, tnllb.NLLBTextConfig(**TEXT), prefix="encoder.",
            proj=projection)
        ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
        out_leaves = dict(jax.tree_util.tree_leaves_with_path(out))
        assert len(ref_leaves) == len(out_leaves)
        for path, value in ref_leaves:
            assert out_leaves[path].dtype == np.float32
            np.testing.assert_allclose(out_leaves[path], np.asarray(value),
                                       rtol=1e-7, err_msg=str(path))


def test_unverified_conversion_gate_raises_as_the_reference(tmp_path,
                                                            monkeypatch):
    """A real checkpoint needs MARQO_ALLOW_UNVERIFIED_CONVERSION=TRUE in
    both packages; with it, an empty checkpoint fails for another
    reason."""
    torch.save({}, str(tmp_path / "open_clip_pytorch_model.bin"))
    props = {"name": "open_clip/nllb-clip-base-siglip/v1",
             "dimensions": 768, "type": "open_clip",
             "localpath": str(tmp_path)}
    monkeypatch.delenv("MARQO_ALLOW_UNVERIFIED_CONVERSION", raising=False)
    with pytest.raises(JaxModelLoadError, match="UNVERIFIED_CONVERSION"):
        jnllb.JaxNLLBSigLIPModel("nllb", props, JaxDevice.CPU).load()
    with pytest.raises(ModelLoadError, match="UNVERIFIED_CONVERSION"):
        tnllb.TorchNLLBSigLIPModel("nllb", props, Device.CPU).load()
    monkeypatch.setenv("MARQO_ALLOW_UNVERIFIED_CONVERSION", "TRUE")
    with pytest.raises(Exception) as error:
        tnllb.TorchNLLBSigLIPModel("nllb", props, Device.CPU).load()
    assert "UNVERIFIED_CONVERSION" not in str(error.value)


@pytest.fixture
def both_wrappers(tmp_path, monkeypatch):
    """One open_clip-pairing checkpoint (text.transformer.encoder.* of an
    M2M100 encoder, text.proj, visual.trunk.* of the SigLIP mirror) loaded
    by both packages' wrappers in fp32, nllb-clip-base-siglip shrunk to
    its widths."""
    sd = {f"text.transformer.{k}": v
          for k, v in _m2m100_encoder_state(seed=7).items()
          if k.startswith("encoder.")}
    torch.manual_seed(8)
    sd["text.proj.weight"] = 0.1 * torch.randn(24, 32)
    sd["text.proj.bias"] = 0.1 * torch.randn(24)
    trunk = VisionTrunk(jsig.SigLIPVisionConfig(**VISION))
    sd.update({f"visual.trunk.{k}": v for k, v in trunk.state_dict().items()})
    torch.save(sd, str(tmp_path / "open_clip_pytorch_model.bin"))
    arch = ((32, 2, 4, 64, 24), (24, 2, 2, 48, 16, 32))
    for module in (jnllb, tnllb):
        monkeypatch.setitem(module.NLLB_SIGLIP_ARCHS, "nllb-clip-base-siglip",
                            arch)
        # the checkpoint's vocabulary, which the arch table leaves out
        monkeypatch.setattr(module, "NLLBTextConfig", functools.partial(
            module.NLLBTextConfig, vocab_size=TEXT["vocab_size"],
            max_positions=64))
    monkeypatch.setenv("MARQO_ALLOW_UNVERIFIED_CONVERSION", "TRUE")
    name = "visheratin/nllb-clip-base-siglip"
    props = {"name": name, "localpath": str(tmp_path)}
    jmodel = jnllb.JaxNLLBSigLIPModel(name, props, JaxDevice.CPU)
    jmodel.compute_dtype = jnp.float32
    jmodel.load()
    tmodel = tnllb.TorchNLLBSigLIPModel(name, props, Device.CPU)
    tmodel.compute_dtype = torch.float32
    tmodel.load()
    return jmodel, tmodel


def test_wrappers_agree_on_one_checkpoint(both_wrappers):
    jmodel, tmodel = both_wrappers
    assert tmodel.dimensions == jmodel.dimensions == 24
    texts = ["hello world", "bonjour le monde, une phrase plus longue", "x"]
    tokens = tmodel._tokenize(texts)
    np.testing.assert_array_equal(tokens, jmodel._tokenize(texts))
    assert (tokens == 1).any()  # rows of different lengths: real padding
    np.testing.assert_allclose(tmodel.encode(texts), jmodel.encode(texts),
                               atol=1e-5)
    images = [np.random.default_rng(i).integers(
        0, 256, size=(40, 30 + 10 * i, 3)).astype(np.uint8)
        for i in range(2)]
    for image in images:
        np.testing.assert_array_equal(tmodel._preprocess_host(image),
                                      jmodel._preprocess_host(image))
    np.testing.assert_allclose(
        tmodel.encode(images, modality=Modality.IMAGE),
        jmodel.encode(images, modality=JaxModality.IMAGE), atol=1e-4)


@pytest.mark.parametrize("name", ["visheratin/nllb-clip-base-siglip",
                                  "visheratin/nllb-siglip-mrl-large"])
def test_registry_entries_dispatch_and_encode(name):
    from marqo_tpu.inference.loaders import \
        resolve_model_class as jax_resolve
    from marqo_tpu_torch.inference.model_registry import \
        get_model_properties_from_registry
    props = dict(get_model_properties_from_registry(name))
    assert jax_resolve(name, props) is jnllb.JaxNLLBSigLIPModel
    assert resolve_model_class(name, props) is tnllb.TorchNLLBSigLIPModel
    props.update({"random_init": True, "dimensions": 24, "image_size": 32})
    model = load_model(name, props, Device.CPU)
    assert isinstance(model, tnllb.TorchNLLBSigLIPModel)
    out = model.encode(["hello world", "bonjour le monde"])
    assert out.shape == (2, 24)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)
    out = model.encode([np.zeros((40, 40, 3), np.uint8)],
                       modality=Modality.IMAGE)
    assert out.shape == (1, 24) and np.isfinite(out).all()
