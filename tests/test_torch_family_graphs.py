"""One CUDA graph per key for every other CLIP-family encoder, the DINO
patcher and the OWL reranker (marqo_tpu_torch/inference/graphs.py), on
the CPU through tests/test_torch_encoder_graphs.py's stand-in capture,
which computes the forward again from the static inputs on every replay.

Each family's wrapper is loaded at a small random width, then given the
JAX package's weights (every array perturbed, fixed tables left exact)
through its ``params_from_jax``, in fp32. For each family:

(a) the graphed ``encode`` (``boxes``, ``score_images``) equals the same
    object's eager result bit for bit;
(b) the graphed towers equal the JAX package's ``*_jit`` functions on the
    same numpy-seeded inputs, within the tolerance the family's own test
    states (SigLIP, NLLB-SigLIP, CoCa, EVA02, ResNet and ConvNeXt towers:
    atol 1e-4, rtol 1e-4; the XLM-R text tower atol 1e-5 and its ViT
    atol 3e-4, rtol 1e-3; DINO maps atol 1e-5; OWL probabilities and
    boxes atol 1e-4);
(c) one capture a key, and the expected keys for a mix of batch sizes (of
    text lengths for NLLB-SigLIP and XLM-R, of hit counts for OWL);
(d) on the CPU, ``EncoderGraphs.run`` is never entered.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from marqo_tpu.models import bert as jbert
from marqo_tpu.models import clip as jclip
from marqo_tpu.models import coca as jcoca
from marqo_tpu.models import convnext_clip as jcnx
from marqo_tpu.models import dino_vit as jdino
from marqo_tpu.models import eva02 as jeva
from marqo_tpu.models import hf_clip as jhf
from marqo_tpu.models import nllb_siglip as jnllb
from marqo_tpu.models import owl_vit as jowl
from marqo_tpu.models import resnet_clip as jres
from marqo_tpu.models import siglip as jsig
from marqo_tpu_torch.inference import batching, graphs, image_patching
from marqo_tpu_torch.inference import rerank as trerank
from marqo_tpu_torch.inference.types import Device, Modality
from marqo_tpu_torch.models import coca as tcoca
from marqo_tpu_torch.models import convnext_clip as tcnx
from marqo_tpu_torch.models import dino_vit as tdino
from marqo_tpu_torch.models import eva02 as teva
from marqo_tpu_torch.models import hf_clip as thf
from marqo_tpu_torch.models import nllb_siglip as tnllb
from marqo_tpu_torch.models import owl_vit as towl
from marqo_tpu_torch.models import resnet_clip as tres
from marqo_tpu_torch.models import siglip as tsig
from tests.test_torch_encoder_graphs import StandIn, _graphed, _refuse

ARCH = {"vocab_size": 64, "context_length": 16,
        "text_hidden_size": 32, "text_layers": 2, "text_heads": 2,
        "text_intermediate": 64, "vision_hidden_size": 32,
        "vision_layers": 2, "vision_heads": 2, "vision_intermediate": 64,
        "patch_size": 16, "swiglu_hidden": 48, "n_queries": 4,
        "pooler_heads": 2, "decoder_layers": 1, "layers": (1, 1, 1, 1),
        "width": 16, "heads": 2, "depths": (1, 1, 1, 1),
        "dims": (8, 16, 32, 64)}
KEY = jax.random.PRNGKey(0)
F32 = jnp.float32


def _init(init, *configs):
    """``init(*configs, KEY)``, compiled as one program (the JAX package's
    init functions op by op take seconds on the CPU)."""
    return jax.jit(functools.partial(init, *configs))(KEY)


def _jax_config(cls, port_config):
    """The JAX package's config of the port config's values."""
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(port_config).items()
                  if k in fields})


def _perturbed(tree, seed=1, exact=("position_table", "rope_table")):
    """Every array moved off its init by N(0, 0.02), the fixed tables
    named in ``exact`` left as they are; numpy fp32."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        a = np.asarray(a, np.float32)
        if any(name in jax.tree_util.keystr(path) for name in exact):
            return a
        return (a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(move, tree)


def _clip_text(jtext):
    """A JAX CLIP text tower's params."""
    vision = jclip.CLIPVisionConfig(image_size=32, patch_size=16,
                                    hidden_size=32, num_layers=1, num_heads=2,
                                    intermediate_size=64, projection_dim=24)
    return _init(jclip.init_clip_params, jtext, vision)["text"]


def _clip_vision(jvision):
    """A JAX CLIP vision tower's params."""
    text = jclip.CLIPTextConfig(vocab_size=8, hidden_size=8, num_layers=1,
                                num_heads=2, intermediate_size=16,
                                projection_dim=jvision.projection_dim)
    return _init(jclip.init_clip_params, text, jvision)["vision"]


def _siglip_vision(jvision):
    """A JAX SigLIP vision tower's params."""
    text = jsig.SigLIPTextConfig(vocab_size=8, hidden_size=8, num_layers=1,
                                 num_heads=1, intermediate_size=8)
    return _init(jsig.init_siglip_params, text, jvision)["vision"]


# --- the families: the port's wrapper, the JAX params and towers -----------

def _siglip(m):
    jtext = _jax_config(jsig.SigLIPTextConfig, m.text_config)
    jvision = _jax_config(jsig.SigLIPVisionConfig, m.vision_config)
    params = _perturbed(_init(jsig.init_siglip_params, jtext, jvision))
    m.encoder = tsig.params_from_jax(params, m.text_config, m.vision_config,
                                     device="cpu")
    return params, {
        "text": lambda p, x: jsig.encode_siglip_text_jit(
            p, x, jtext, compute_dtype=F32),
        "vision": lambda p, x: jsig.encode_siglip_image_jit(
            p, x, jvision, compute_dtype=F32)}


def _nllb(m):
    jtext = _jax_config(jnllb.NLLBTextConfig, m.text_config)
    jvision = _jax_config(jsig.SigLIPVisionConfig, m.vision_config)
    params = _perturbed({
        "text": _init(jnllb.init_nllb_text_params, jtext),
        "vision": _siglip_vision(jvision)})
    m.encoder = tnllb.params_from_jax(params, m.text_config, m.vision_config,
                                      device="cpu")
    return params, {
        "text": lambda p, x: jnllb.encode_nllb_text_jit(
            p, x, jtext, compute_dtype=F32),
        "vision": lambda p, x: jsig.encode_siglip_image_jit(
            p, x, jvision, compute_dtype=F32)}


def _coca(m):
    configs = (m.text_config, m.vision_config, m.decoder_config)
    jconfigs = [_jax_config(cls, c) for cls, c in zip(
        (jcoca.CoCaTextConfig, jcoca.CoCaVisionConfig,
         jcoca.CoCaDecoderConfig), configs)]
    params = _perturbed(_init(jcoca.init_coca_params, *jconfigs))
    m.encoder = tcoca.params_from_jax(params, *configs, device="cpu")
    return params, {
        "text": lambda p, x: jcoca.encode_coca_text_jit(
            p, x, jconfigs[0], compute_dtype=F32),
        "vision": lambda p, x: jcoca.encode_coca_image_jit(
            p, x, jconfigs[1], compute_dtype=F32)}


def _eva02(m):
    jtext = _jax_config(jclip.CLIPTextConfig, m.text_config)
    jvision = _jax_config(jeva.EVA02VisionConfig, m.vision_config)
    params = _perturbed(_init(jeva.init_eva02_params, jtext, jvision))
    m.encoder = teva.params_from_jax(params, m.text_config, m.vision_config,
                                     device="cpu")
    return params, {
        "text": lambda p, x: jeva.encode_eva02_text_jit(
            p, x, jtext, compute_dtype=F32),
        "vision": lambda p, x: jeva.encode_eva02_image_jit(
            p, x, jvision, compute_dtype=F32)}


def _xlmr(m):
    jtext = _jax_config(jbert.TextEncoderConfig, m.text_config)
    jvision = _jax_config(jclip.CLIPVisionConfig, m.vision_config)
    H, D = m.text_config.hidden_size, m.vision_config.projection_dim
    rng = np.random.default_rng(2)
    params = _perturbed({
        "text": _init(jbert.init_params, jtext),
        "vision": _clip_vision(jvision),
        "proj_w1": rng.standard_normal((H, 28)) * 0.1,
        "proj_w2": rng.standard_normal((28, D)) * 0.1})
    m.encoder = thf.params_from_jax(params, m.text_config, m.vision_config,
                                    device="cpu")
    return params, {
        "text": lambda p, x: jhf.encode_hf_clip_text_jit(
            p, x[:, 0], x[:, 1], jtext, compute_dtype=F32),
        "vision": lambda p, x: jclip.encode_clip_image_jit(
            {"vision": p["vision"]}, x, jvision, compute_dtype=F32)}


def _conv(init, encode, params_from_jax, jvision_cls):
    def build(m):
        jtext = _jax_config(jclip.CLIPTextConfig, m.text_config)
        jvision = _jax_config(jvision_cls, m.vision_config)
        params = _perturbed({"text": _clip_text(jtext),
                             "vision": _init(init, jvision)["vision"]})
        m.encoder = params_from_jax(params, m.text_config, m.vision_config,
                                    device="cpu")
        return params, {
            "text": lambda p, x: jclip.encode_clip_text_jit(
                p, x, jtext, compute_dtype=F32),
            "vision": lambda p, x: encode(p, x, jvision, compute_dtype=F32)}
    return build


TOL = {"text": dict(atol=1e-4, rtol=1e-4), "vision": dict(atol=1e-4,
                                                         rtol=1e-4)}
# name: (wrapper class, registry name token, image size, weights, tolerance)
FAMILIES = {
    "siglip": (tsig.TorchSigLIPModel, "ViT-B-16-SigLIP", 32, _siglip, TOL),
    "nllb_siglip": (tnllb.TorchNLLBSigLIPModel, "nllb-clip-base-siglip", 32,
                    _nllb, TOL),
    "coca": (tcoca.TorchCoCaModel, "coca_ViT-B-32", 32, _coca, TOL),
    "eva02": (teva.TorchEVA02Model, "EVA02-B-16", 32, _eva02, TOL),
    "xlmr_clip": (thf.TorchHFCLIPModel, "xlm-roberta-base-ViT-B-32", 32,
                  _xlmr, {"text": dict(atol=1e-5, rtol=0),
                          "vision": dict(atol=3e-4, rtol=1e-3)}),
    "rn50": (tres.TorchResNetCLIPModel, "RN50", 64,
             _conv(jres.init_resnet_clip_params,
                   jres.encode_resnet_clip_image_jit, tres.params_from_jax,
                   jres.ResNetVisionConfig), TOL),
    "convnext": (tcnx.TorchConvNextCLIPModel, "convnext_base", 64,
                 _conv(jcnx.init_convnext_params,
                       jcnx.encode_convnext_clip_image_jit,
                       tcnx.params_from_jax, jcnx.ConvNextVisionConfig), TOL),
}
# the families whose text length is the batch's own
RAGGED_TEXT = ("nllb_siglip", "xlmr_clip")


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, the port's fp32 wrapper on the CPU holding the JAX package's
    weights, those weights as numpy, the JAX package's jitted towers)."""
    cls, token, size, weights, _ = FAMILIES[request.param]
    props = {"name": f"open_clip/{token}", "type": "open_clip",
             "random_init": True, "dimensions": 24, "image_size": size,
             "architecture": ARCH}
    model = cls(f"graphs-{request.param}", props, Device.CPU)
    model.compute_dtype = torch.float32
    model.load()
    params, towers = weights(model)
    return request.param, model, params, towers


TEXTS = ["a photo", "two red dogs on a long sunny beach at noon", "x",
         "une photo rouge", "the quick brown fox jumps over the lazy dog",
         "bonjour", "a small cat", "three", "blue sky over grey sea"]


def _images(n, seed=0):
    """n uint8 images of differing shapes, for the host preprocessing."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (40 + 8 * i, 48 + 4 * (i % 3), 3),
                         dtype=np.uint8) for i in range(n)]


def _text_array(name, model, texts):
    """The host array the text tower's batches are cut from."""
    if name != "xlmr_clip":
        return model._tokenize(texts)
    batch = model.tokenizer.encode_batch(texts)
    ids = batch["input_ids"] % model.text_config.vocab_size
    return np.stack([ids, batch["attention_mask"]], axis=1).astype(np.int32)


def _tower_arrays(name, model, n_texts, n_images, seed=5):
    pixels = np.random.default_rng(seed).integers(
        0, 256, (n_images, model.vision_config.image_size,
                 model.vision_config.image_size, 3), dtype=np.uint8)
    return {"text": _text_array(name, model, TEXTS[:n_texts]),
            "vision": pixels}


def _graphed_towers(name, model):
    """The towers' rows through the wrapper's own batch path."""
    if name == "xlmr_clip":
        return {"text": lambda array, texts: model._encode_text(texts),
                "vision": lambda array, texts: model._run(array, "vision")}
    return {tower: (lambda array, texts, tower=tower:
                    model._run(array, tower))
            for tower in ("text", "vision")}


def test_graphed_encode_equals_eager_bit_for_bit(family, monkeypatch):
    name, model, _, _ = family
    texts, images = TEXTS[:5], _images(3)
    eager = (model.encode(texts), model.encode(images,
                                               modality=Modality.IMAGE))
    capture = _graphed(monkeypatch, model)
    for _ in range(2):  # the capture's call, then a replay
        np.testing.assert_array_equal(model.encode(texts), eager[0])
        np.testing.assert_array_equal(
            model.encode(images, modality=Modality.IMAGE), eager[1])
    assert capture.captures == 2 == len(model.graphs.graphs)


def test_graphed_towers_match_jax(family, monkeypatch):
    name, model, params, towers = family
    _graphed(monkeypatch, model)
    arrays = _tower_arrays(name, model, n_texts=5, n_images=3)
    for tower, run in _graphed_towers(name, model).items():
        out = run(arrays[tower], TEXTS[:5])
        ref = np.asarray(towers[tower](params, jnp.asarray(arrays[tower])))
        assert out.shape == ref.shape == (len(arrays[tower]), 24)
        np.testing.assert_allclose(out, ref, **FAMILIES[name][4][tower])
    assert sorted(key[0] for key in model.graphs.graphs) == \
        ["text", "vision"]


def test_one_capture_a_key(family, monkeypatch):
    """Text batches of 1, 3, 9, 2 and 3 (buckets 1, 8, 16, 8, 8) and image
    batches of 1, 5, 9 and 7 (1, 8, 16, 8): one key a bucket, and for the
    families whose texts pad to the batch's longest, one a length too (the
    batch of 2 holds a longer text than those of 3)."""
    name, model, _, _ = family
    capture = _graphed(monkeypatch, model)
    expected = set()
    for texts in (TEXTS[-1:], TEXTS[-3:], TEXTS, TEXTS[:2], TEXTS[-3:]):
        model.encode(texts)
        bucket = batching.pick_batch_bucket(len(texts))
        expected.add(("text", (bucket,) +
                      _text_array(name, model, texts).shape[1:]))
    for n in (1, 5, 9, 7):
        model.encode(_images(n, seed=n), modality=Modality.IMAGE)
        size = model.vision_config.image_size
        expected.add(("vision", (batching.pick_batch_bucket(n), size, size,
                                 3)))
    keys = {(key[0], key[3][0][0]) for key in model.graphs.graphs}
    assert keys == expected
    assert capture.captures == len(keys)
    text_lengths = {shape[-1] for tower, shape in keys if tower == "text"}
    assert (len(text_lengths) > 1) == (name in RAGGED_TEXT)
    assert len(keys) == (7 if name in RAGGED_TEXT else 6)


def test_cpu_families_never_enter_the_graphs(family, monkeypatch):
    name, model, _, _ = family
    monkeypatch.setattr(graphs.EncoderGraphs, "run", _refuse)
    assert batching.graphs_for(model) is None
    assert model.encode(TEXTS[:3]).shape == (3, 24)
    assert model.encode(_images(2), modality=Modality.IMAGE).shape == \
        (2, 24)
    if hasattr(model, "warmup"):
        assert model.warmup(images=2) == 4


# --- the DINO patcher ---------------------------------------------------------

DINO = dict(image_size=64, patch_size=16, hidden_size=64, num_heads=2,
            num_layers=2)


@pytest.fixture(scope="module")
def dino():
    """A dino-v1 patcher on the CPU holding the JAX package's weights at a
    small width, fp32; the weights and the JAX config."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("MARQO_PATCH_MODELS_RANDOM_INIT", "TRUE")
        patch.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")
        patcher = image_patching._DinoPatcher("abs")
    jconfig = jdino.DinoViTConfig(**DINO)
    params = _perturbed(_init(jdino.init_params, jconfig))
    patcher.config = tdino.DinoViTConfig(**DINO)
    patcher.model = tdino.params_from_jax(params, patcher.config,
                                          device="cpu")
    return patcher, params, jconfig


def _patcher_graphed(monkeypatch, patcher):
    capture = StandIn()
    patcher.graphs = graphs.EncoderGraphs("cpu", capture=capture)
    monkeypatch.setattr(batching, "card_graphs",
                        lambda g: g if g is patcher.graphs else None)
    return capture


def _photos(n, seed=7, shape=(90, 120, 3)):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        image = np.zeros(shape, np.uint8)
        image[20 + 3 * i:60, 30:90 - 5 * i] = rng.integers(120, 256, 3)
        out.append((image + rng.integers(0, 40, shape)).astype(np.uint8))
    return out


def test_dino_graphed_boxes_equal_eager_bit_for_bit(dino, monkeypatch):
    patcher, _, _ = dino
    photos = _photos(3)
    eager = [patcher.boxes(image) for image in photos]
    capture = _patcher_graphed(monkeypatch, patcher)
    assert [patcher.boxes(image) for image in photos] == eager
    assert capture.captures == 1 == len(patcher.graphs.graphs)


def test_dino_graphed_maps_match_jax(dino, monkeypatch):
    patcher, params, jconfig = dino
    _patcher_graphed(monkeypatch, patcher)
    pixels = np.random.default_rng(3).integers(
        0, 256, (1, 64, 64, 3), dtype=np.uint8)
    out = patcher.attention(pixels).numpy()
    ref = np.asarray(jdino.last_selfattention_jit(
        params, jnp.asarray(pixels), jconfig, compute_dtype=F32))
    assert out.shape == ref.shape == (1, 2, 4, 4)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_dino_one_capture_a_key(dino, monkeypatch):
    """Every image resizes to the one (1, size, size, 3) key; each patcher
    (dino-v1 and dino-v2) holds its own graphs."""
    patcher, _, _ = dino
    capture = _patcher_graphed(monkeypatch, patcher)
    for image in _photos(2) + _photos(2, seed=8, shape=(200, 64, 3)):
        patcher.boxes(image)
    (key,) = patcher.graphs.graphs
    assert key[0] == "dino" and key[3] == (((1, 64, 64, 3), "|u1"),)
    assert capture.captures == 1
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("MARQO_PATCH_MODELS_RANDOM_INIT", "TRUE")
        patch.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")
        image_patching.clear_patchers()
        try:
            v1, v2 = (image_patching._get_patcher(m)
                      for m in ("dino-v1", "dino-v2"))
            assert v1.graphs is not v2.graphs and \
                v1.graphs.lock is not v2.graphs.lock
        finally:
            image_patching.clear_patchers()


def test_dino_cpu_never_enters_the_graphs(dino, monkeypatch):
    patcher, _, _ = dino
    monkeypatch.setattr(graphs.EncoderGraphs, "run", _refuse)
    assert batching.card_graphs(patcher.graphs) is None
    boxes, scores = patcher.boxes(_photos(1)[0])
    assert len(boxes) == len(scores)


# --- the OWL reranker ---------------------------------------------------------

OWL_PROPS = {"random_init": True,
             "architecture": {"hidden_size": 32, "layers": 2, "heads": 2,
                              "image_size": 32, "patch_size": 8}}


@pytest.fixture(scope="module")
def owl():
    """The port's OWL reranker on the CPU holding the JAX package's
    weights, fp32; the weights and the JAX config."""
    reranker = trerank.TorchOwlReranker("owl/ViT-B/32", Device.CPU,
                                        OWL_PROPS)
    reranker.load()
    jconfig = jowl.OwlViTConfig(
        text=_jax_config(jclip.CLIPTextConfig, reranker.config.text),
        vision=_jax_config(jclip.CLIPVisionConfig, reranker.config.vision))
    params = _perturbed(_init(jowl.init_owl_params, jconfig))
    reranker.model = towl.params_from_jax(params, reranker.config,
                                          device="cpu")
    return reranker, params, jconfig


def _owl_graphed(monkeypatch, reranker):
    capture = StandIn()
    reranker.graphs = graphs.EncoderGraphs("cpu", capture=capture)
    monkeypatch.setattr(batching, "card_graphs",
                        lambda g: g if g is reranker.graphs else None)
    return capture


@pytest.fixture(scope="module")
def hit_images(tmp_path_factory):
    directory = tmp_path_factory.mktemp("owl")
    paths = []
    for i, image in enumerate(_photos(5, seed=11)):
        path = str(directory / f"hit{i}.png")
        Image.fromarray(image).save(path)
        paths.append(path)
    return paths


def test_owl_graphed_scores_equal_eager_bit_for_bit(owl, hit_images,
                                                    monkeypatch):
    reranker, _, _ = owl
    eager = reranker.score_images("a bright blob", hit_images)
    capture = _owl_graphed(monkeypatch, reranker)
    for _ in range(2):
        assert reranker.score_images("a bright blob", hit_images) == eager
    assert capture.captures == 1


def test_owl_graphed_detections_match_jax(owl, monkeypatch):
    reranker, params, jconfig = owl
    _owl_graphed(monkeypatch, reranker)
    pixels = np.random.default_rng(4).integers(0, 256, (3, 32, 32, 3),
                                               dtype=np.uint8)
    ids = reranker._tokenize(["a bright blob"])
    out = reranker.detections(pixels, ids).numpy()
    logits, boxes = jowl.detect_jit(params, jnp.asarray(pixels),
                                    jnp.asarray(ids), jconfig,
                                    compute_dtype=F32)
    ref = np.concatenate([np.asarray(jax.nn.sigmoid(logits[..., :1])),
                          np.asarray(boxes)], axis=-1)
    assert out.shape == ref.shape == (3, 16, 5)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_owl_one_capture_a_hit_count(owl, hit_images, monkeypatch):
    """The key is the exact number of images scored (no bucket), as
    ``detect_jit`` compiles one program a shape; a missing image drops out
    of the count."""
    reranker, _, _ = owl
    capture = _owl_graphed(monkeypatch, reranker)
    for pointers in (hit_images[:1], hit_images[:3], hit_images[1:4],
                     hit_images, hit_images[:2] + ["/nonexistent/x.png"]):
        reranker.score_images("a bright blob", pointers)
    counts = sorted(key[3][0][0][0] for key in reranker.graphs.graphs)
    assert counts == [1, 2, 3, 5] and capture.captures == 4
    assert {key[3][1][0] for key in reranker.graphs.graphs} == \
        {(1, reranker.config.text.max_positions)}


def test_owl_cpu_never_enters_the_graphs(owl, hit_images, monkeypatch):
    reranker, _, _ = owl
    monkeypatch.setattr(graphs.EncoderGraphs, "run", _refuse)
    assert batching.card_graphs(reranker.graphs) is None
    out = reranker.score_images("a query", hit_images[:2])
    assert len(out) == 2 and all(0.0 <= r["score"] <= 1.0 for r in out)
