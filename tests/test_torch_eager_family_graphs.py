"""One CUDA graph per key for Stella, the cross-encoder, the YOLOX and
Faster R-CNN patchers and LanguageBind's four towers
(marqo_tpu_torch/inference/graphs.py), on the CPU through
tests/test_torch_encoder_graphs.py's stand-in capture, which computes the
forward again from the static inputs on every replay.

Each object is loaded at a small random width (2 layers, width 32; the
detectors at width 0.125 and 64 px), then given the JAX package's weights
(every array perturbed) through the port's ``params_from_jax``, in fp32.
For each:

(a) the graphed ``encode``, ``score`` or ``boxes`` equals the same
    object's eager result bit for bit;
(b) the graphed forward equals the JAX package's jitted function on the
    same numpy-seeded inputs, within the tolerance of the family's own
    test (Stella: cosine > 1 - 1e-5 and atol 1e-5; the cross-encoder atol
    1e-5; YOLOX and Faster R-CNN 1e-4 of each output group's largest
    magnitude; LanguageBind video atol 3e-5, its other towers cosine >
    1 - 1e-5 and atol 1e-4);
(c) one capture a key, and the expected keys for a mix of batch sizes (of
    hit counts for the cross-encoder, of chunk counts for audio), Stella's
    ``warmup`` capturing its hot buckets;
(d) on the CPU, ``EncoderGraphs.run`` is never entered.

Besides: the detectors' warm run and capture run with cuDNN's TF32 off,
and the flag comes back after; a LanguageBind tower assigned anew is
never served by the old tower's capture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.models import bert as jbert
from marqo_tpu.models import clip as jclip
from marqo_tpu.models import cross_encoder as jce
from marqo_tpu.models import frcnn as jfrcnn
from marqo_tpu.models import languagebind as jlb
from marqo_tpu.models import stella as jstella
from marqo_tpu.models import yolox as jyolo
from marqo_tpu_torch.inference import batching, graphs, image_patching
from marqo_tpu_torch.inference.loaders import TorchStellaModel
from marqo_tpu_torch.inference.types import Device, Modality
from marqo_tpu_torch.models import cross_encoder as tce
from marqo_tpu_torch.models import frcnn as tfrcnn
from marqo_tpu_torch.models import languagebind as tlb
from marqo_tpu_torch.models import stella as tstella
from marqo_tpu_torch.models import yolox as tyolo
from tests.test_torch_encoder_graphs import StandIn, _graphed, _refuse
from tests.test_torch_family_graphs import _init, _jax_config, _perturbed
from tests.test_torch_yolox import GROUPS, _random_stats

F32 = jnp.float32
TEXTS = ["a photo", "two red dogs on a long sunny beach at noon", "x",
         "une photo rouge", "the quick brown fox jumps over the lazy dog",
         "bonjour", "a small cat", "three", "blue sky over grey sea"]


def _cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) *
                              np.linalg.norm(b, axis=-1))


def _card_graphed(monkeypatch, obj):
    """Give ``obj`` (a patcher, a reranker, LanguageBind) its graphs on the
    CPU, captured by the stand-in."""
    capture = StandIn()
    obj.graphs = graphs.EncoderGraphs("cpu", capture=capture)
    monkeypatch.setattr(batching, "card_graphs",
                        lambda g: g if g is obj.graphs else None)
    return capture


def _shapes(cache):
    """Each key's (tower, first input's shape)."""
    return {(key[0], key[3][0][0]) for key in cache.graphs}


# --- Stella -------------------------------------------------------------------

STELLA_PROPS = {"type": "hf_stella", "random_init": True, "dimensions": 24,
                "tokens": 128,
                "architecture": {"vocab_size": 128, "hidden_size": 32,
                                 "num_layers": 2, "num_heads": 2,
                                 "intermediate_size": 64,
                                 "rope_theta": 1000.0}}


@pytest.fixture(scope="module")
def stella():
    """The port's Stella wrapper on the CPU holding the JAX package's
    weights, fp32; the weights and the JAX config."""
    model = TorchStellaModel("graphs-stella", dict(STELLA_PROPS), Device.CPU)
    model.compute_dtype = torch.float32
    model.load()
    jconfig = _jax_config(jstella.StellaConfig, model.config)
    params = _perturbed(_init(jstella.init_params, jconfig))
    model.encoder = tstella.params_from_jax(params, model.config,
                                            device="cpu")
    return model, params, jconfig


def test_stella_graphed_encode_equals_eager_bit_for_bit(stella,
                                                        monkeypatch):
    model, _, _ = stella
    batches = (TEXTS[:1], TEXTS, TEXTS[2:5])
    eager = [model.encode(texts) for texts in batches]
    capture = _graphed(monkeypatch, model)
    for _ in range(2):  # the capture's call, then a replay
        for texts, ref in zip(batches, eager):
            np.testing.assert_array_equal(model.encode(texts), ref)
    assert capture.captures == 3 == len(model.graphs.graphs)
    assert {key[0] for key in model.graphs.graphs} == {"padded"}


def test_stella_graphed_forward_matches_jax(stella, monkeypatch):
    model, params, jconfig = stella
    _graphed(monkeypatch, model)
    rng = np.random.default_rng(0)
    lengths = rng.integers(3, 25, 8)
    mask = (np.arange(32)[None] < lengths[:, None]).astype(np.int32)
    ids = (rng.integers(2, 128, (8, 32)) * mask).astype(np.int32)
    out = model._forward(ids, mask).numpy()
    ref = np.asarray(jstella.encode_tokens_jit(
        params, jnp.asarray(ids), jnp.asarray(mask), jconfig,
        compute_dtype=F32))
    assert out.shape == ref.shape == (8, 24)
    assert (_cosines(out, ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    assert list(model.graphs.graphs)[0][2] == (model.encoder.config,)


def _bucket(model, texts):
    """The (batch, seq) bucket a batch of ``texts`` pads to."""
    lengths = model.tokenizer.encode_batch(texts)["lengths"]
    return (batching.pick_batch_bucket(len(texts)),
            batching.pick_seq_bucket(min(max(lengths),
                                         model.tokenizer.max_length)))


def test_stella_one_capture_a_key_and_warmup(stella, monkeypatch):
    """Batches of 1, 9, 3 and 1 texts take one key a (batch, seq) bucket
    (Stella never packs); the inherited ``warmup`` then captures the query
    buckets of its first four sequence lengths and the ingest bucket."""
    model, _, _ = stella
    capture = _graphed(monkeypatch, model)
    batches = (TEXTS[:1], TEXTS, TEXTS[2:5], TEXTS[3:4])
    for texts in batches:
        model.encode(texts)
    served = {_bucket(model, texts) for texts in batches}
    assert _shapes(model.graphs) == {("padded", s) for s in served}
    assert capture.captures == len(served) >= 3
    assert model.warmup() == 5
    warm = {(1, s) for s in batching.seq_buckets()[:4]} | {(256, 128)}
    assert _shapes(model.graphs) == \
        {("padded", shape) for shape in warm | served}
    assert capture.captures == len(model.graphs.graphs) == \
        len(warm | served)


def test_stella_cpu_never_enters_the_graphs(stella, monkeypatch):
    model, _, _ = stella
    monkeypatch.setattr(graphs.EncoderGraphs, "run", _refuse)
    assert batching.graphs_for(model) is None
    assert model.encode(TEXTS[:3]).shape == (3, 24)
    assert model.warmup([[1, 16], [8, 32]]) == 2


# --- the cross-encoder -------------------------------------------------------

CE_ARCH = {"vocab_size": 128, "hidden_size": 32, "num_layers": 2,
           "num_heads": 2, "intermediate_size": 64}


@pytest.fixture(scope="module")
def cross_encoder():
    """The port's cross-encoder on the CPU holding the JAX package's
    weights, fp32; the weights and the JAX config."""
    model = tce.TorchCrossEncoder("graphs-ms-marco", Device.CPU,
                                  {"random_init": True,
                                   "architecture": CE_ARCH})
    model.compute_dtype = torch.float32
    model.load()
    jconfig = _jax_config(jbert.TextEncoderConfig, model.config)
    H = jconfig.hidden_size
    rng = np.random.default_rng(2)
    params = _perturbed({
        "encoder": _init(jbert.init_params, jconfig),
        "pooler_w": rng.standard_normal((H, H)) * 0.05,
        "pooler_b": np.zeros(H), "classifier_w": rng.standard_normal(
            (H, 1)), "classifier_b": np.full(1, 0.3)})
    model.model = tce.params_from_jax(params, model.config, device="cpu")
    return model, params, jconfig


HITS = [f"document {i} about " + " ".join(TEXTS[i % 9].split()[:2 + i % 5])
        for i in range(12)]


def test_cross_encoder_graphed_score_equals_eager_bit_for_bit(
        cross_encoder, monkeypatch):
    model, _, _ = cross_encoder
    mixes = (HITS[:10], HITS[:1], HITS[3:6])
    eager = [model.score("a red photo", hits) for hits in mixes]
    capture = _card_graphed(monkeypatch, model)
    for _ in range(2):
        for hits, ref in zip(mixes, eager):
            np.testing.assert_array_equal(model.score("a red photo", hits),
                                          ref)
    assert capture.captures == len(model.graphs.graphs) == 3


def test_cross_encoder_graphed_scores_match_jax(cross_encoder, monkeypatch):
    model, params, jconfig = cross_encoder
    _card_graphed(monkeypatch, model)
    rng = np.random.default_rng(3)
    lengths = rng.integers(4, 33, 8)
    mask = (np.arange(32)[None] < lengths[:, None]).astype(np.int32)
    ids = (rng.integers(5, 128, (8, 32)) * mask).astype(np.int32)
    split = rng.integers(2, lengths)
    types = ((np.arange(32)[None] >= split[:, None]) &
             (mask > 0)).astype(np.int32)
    out = model.scores(ids, mask, types).numpy()
    ref = np.asarray(jce.cross_encoder_scores(
        params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types),
        jconfig, compute_dtype=F32))
    assert out.shape == ref.shape == (8,)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    (key,) = model.graphs.graphs
    assert key[0] == "scores" and key[2] == (model.model.config,)
    assert [shape for shape, _ in key[3]] == [(8, 32)] * 3


def test_cross_encoder_one_capture_a_hit_count_bucket(cross_encoder,
                                                      monkeypatch):
    """Hit counts 1, 3, 10, 5, 9 and 12 take the batch buckets 1, 8, 16,
    8, 16 and 16, at the sequence bucket of each call's longest pair: one
    key a (bucket, length)."""
    model, _, _ = cross_encoder
    capture = _card_graphed(monkeypatch, model)
    expected = set()
    query = "a red photo"
    for n in (1, 3, 10, 5, 9, 12):
        hits = HITS[:n]
        assert model.score(query, hits).shape == (n,)
        length = batching.pick_seq_bucket(min(
            model.tokenizer.max_length,
            model.tokenizer.max_pair_length([query] * n, hits)))
        expected.add(("scores", (batching.pick_batch_bucket(n), length)))
    assert _shapes(model.graphs) == expected
    assert capture.captures == len(expected) >= 3


def test_cross_encoder_cpu_never_enters_the_graphs(cross_encoder,
                                                   monkeypatch):
    model, _, _ = cross_encoder
    monkeypatch.setattr(graphs.EncoderGraphs, "run", _refuse)
    assert batching.card_graphs(model.graphs) is None
    assert model.score("a query", HITS[:3]).shape == (3,)


# --- the YOLOX and Faster R-CNN patchers ---------------------------------------

SIZE = 64


def _patcher(cls):
    """A random-init patcher of ``cls`` on the CPU."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("MARQO_PATCH_MODELS_RANDOM_INIT", "TRUE")
        patch.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")
        patch.setenv("MARQO_FRCNN_WIDTH", "0.125")
        return cls()


@pytest.fixture(scope="module")
def yolox():
    """A marqo-yolo patcher on the CPU holding the JAX package's weights
    at width 0.125 and 64 px (tests/test_torch_yolox.py's, the stem / 255
    for the raw pixels); the weights and the JAX config."""
    patcher = _patcher(image_patching._YoloxPatcher)
    jconfig = jyolo.YoloxConfig(width=0.125, input_size=SIZE)
    params = _random_stats(jax.tree.map(np.asarray,
                                        _init(jyolo.init_params, jconfig)),
                           np.random.default_rng(1))
    params["backbone"]["stem"]["conv"]["w"] /= 255.0
    patcher.config = tyolo.YoloxConfig(width=0.125, input_size=SIZE)
    patcher.model = tyolo.params_from_jax(params, patcher.config,
                                          device="cpu")
    return patcher, params, jconfig


@pytest.fixture(scope="module")
def frcnn():
    """A frcnn patcher on the CPU holding the JAX package's weights at
    width 0.125 and 64 px, every array perturbed; the weights and the JAX
    config."""
    patcher = _patcher(image_patching._FrcnnPatcher)
    jconfig = jfrcnn.FrcnnConfig(width=0.125, input_size=SIZE)
    params = _perturbed(_init(jfrcnn.init_params, jconfig), seed=1,
                        exact=())
    patcher.config = tfrcnn.FrcnnConfig(width=0.125, input_size=SIZE)
    patcher.model = tfrcnn.params_from_jax(params, patcher.config,
                                           device="cpu")
    return patcher, params, jconfig


DETECTORS = ("yolox", "frcnn")


@pytest.fixture(params=DETECTORS)
def detector(request):
    return request.param, request.getfixturevalue(request.param)[0]


def _photos(n, seed=7, shape=(90, 120, 3)):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        image = np.zeros(shape, np.uint8)
        image[20 + 3 * i:60, 30:90 - 5 * i] = rng.integers(120, 256, 3)
        out.append((image + rng.integers(0, 40, shape)).astype(np.uint8))
    return out


def test_detector_graphed_boxes_equal_eager_bit_for_bit(detector,
                                                        monkeypatch):
    name, patcher = detector
    photos = _photos(3) + _photos(1, seed=8, shape=(200, 64, 3))
    eager = [patcher.boxes(image) for image in photos]
    assert all(boxes for boxes, _ in eager)
    capture = _card_graphed(monkeypatch, patcher)
    assert [patcher.boxes(image) for image in photos] == eager
    # every image letterboxes or resizes to the one key
    (key,) = patcher.graphs.graphs
    assert key[0] == name and key[2] == (patcher.config,)
    assert key[3] == (((1, SIZE, SIZE, 3), "<f4"),)
    assert capture.captures == 1


def test_yolox_graphed_outputs_match_jax(yolox, monkeypatch):
    patcher, params, jconfig = yolox
    _card_graphed(monkeypatch, patcher)
    pixels = np.random.default_rng(2).uniform(
        0, 255, (1, SIZE, SIZE, 3)).astype(np.float32)
    out = patcher.outputs(pixels).numpy()
    ref = np.asarray(jyolo.forward_jit(jax.tree.map(jnp.asarray, params),
                                       jnp.asarray(pixels), jconfig))
    assert out.shape == ref.shape and out.dtype == np.float32
    for group, s in GROUPS.items():
        err = np.abs(out[..., s] - ref[..., s]).max() / \
            np.abs(ref[..., s]).max()
        assert err <= 1e-4, (group, err)


def test_frcnn_graphed_levels_match_jax(frcnn, monkeypatch):
    """The graph's one tensor, split by ``split_levels`` as ``boxes``
    splits it, is the JAX package's ten level outputs."""
    patcher, params, jconfig = frcnn
    _card_graphed(monkeypatch, patcher)
    pixels = np.random.default_rng(2).standard_normal(
        (1, SIZE, SIZE, 3)).astype(np.float32)
    flat = patcher.levels(pixels).numpy()
    ref = [[np.asarray(t) for t in level] for level in jfrcnn.forward_jit(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pixels), jconfig)]
    ours = tfrcnn.split_levels(flat, patcher.config)
    assert len(ours) == len(ref) == 5
    assert flat.size == sum(t.size for level in ref for t in level)
    for level_ours, level_ref in zip(ours, ref):
        for mine, theirs in zip(level_ours, level_ref):
            assert mine.shape == theirs.shape
            err = np.abs(mine - theirs).max() / np.abs(theirs).max()
            assert err <= 1e-4, (theirs.shape, err)


def test_detector_capture_runs_with_tf32_off(detector, monkeypatch):
    """The graph is captured from the model itself, whose forward turns
    cuDNN's TF32 off: the warm run and the capture's forward both see the
    flag off, and the flag the process had comes back after."""
    _, patcher = detector
    seen = []
    body = type(patcher.model)._forward

    def recorded(model, x):
        seen.append(torch.backends.cudnn.allow_tf32)
        return body(model, x)

    monkeypatch.setattr(type(patcher.model), "_forward", recorded)
    capture = _card_graphed(monkeypatch, patcher)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    patcher.boxes(_photos(1)[0])
    # the warm run, the capture, the replay (the stand-in's recompute)
    assert capture.captures == 1 and seen == [False] * 3
    assert torch.backends.cudnn.allow_tf32 is True


def test_detector_cpu_never_enters_the_graphs(detector, monkeypatch):
    _, patcher = detector
    monkeypatch.setattr(graphs.EncoderGraphs, "run", _refuse)
    assert batching.card_graphs(patcher.graphs) is None
    boxes, scores = patcher.boxes(_photos(1)[0])
    assert len(boxes) == len(scores) > 0


# --- LanguageBind --------------------------------------------------------------

LB_PROPS = {"type": "languagebind", "dimensions": 24, "random_init": True,
            "image_size": 32,
            "architecture": {"patch_size": 8, "audio_frames": 96,
                             "audio_patch": 16, "vocab_size": 64,
                             "hidden_size": 32, "num_layers": 2,
                             "num_heads": 2, "intermediate_size": 64},
            "supported_modalities": ["language", "image", "audio", "video"]}
VIDEO = jlb.VideoTowerConfig(image_size=32, patch_size=8, num_frames=3,
                             add_time_attn=True, hidden_size=32,
                             num_layers=2, num_heads=4, intermediate_size=64,
                             projection_dim=24)


def _lb_model(name="graphs-lb"):
    model = tlb.TorchLanguageBindModel(name, dict(LB_PROPS), Device.CPU)
    model.compute_dtype = torch.float32
    model.load()
    return model


@pytest.fixture(scope="module")
def languagebind():
    """The port's LanguageBind on the CPU holding the JAX package's text,
    image, audio and video towers, every array perturbed, fp32; the
    weights and the JAX configs by tower."""
    model = _lb_model()
    jconfigs = {
        "text": _jax_config(jclip.CLIPTextConfig, model.text_config),
        "image": _jax_config(jclip.CLIPVisionConfig, model.vision_config),
        "audio": _jax_config(jlb.AudioTowerConfig, model.audio_config),
        "video": VIDEO}
    params = _perturbed({
        **_init(jclip.init_clip_params, jconfigs["text"], jconfigs["image"]),
        "audio": _init(jlb.init_audio_tower, jconfigs["audio"]),
        "video": _init(jlb.init_video_tower, VIDEO)})
    model.video_config = tlb.VideoTowerConfig(**dataclasses.asdict(VIDEO))
    model.encoder = tlb.params_from_jax(
        params, model.text_config, model.vision_config, model.audio_config,
        model.video_config, device="cpu")
    return model, params, jconfigs


def _waves(n, seed=9):
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.standard_normal(16000 + 4000 * i)).astype(np.float32)
            for i in range(n)]


def _videos(n, seed=10, frames=3):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
             for _ in range(frames)] for _ in range(n)]


def _lb_inputs():
    """A mix of each modality's contents, as ``encode`` takes them."""
    return {Modality.TEXT: TEXTS[:4], Modality.IMAGE: _photos(3),
            Modality.AUDIO: _waves(2), Modality.VIDEO: _videos(2)}


def test_languagebind_graphed_encode_equals_eager_bit_for_bit(
        languagebind, monkeypatch):
    model, _, _ = languagebind
    inputs = _lb_inputs()
    eager = {m: model.encode(c, modality=m) for m, c in inputs.items()}
    capture = _card_graphed(monkeypatch, model)
    for _ in range(2):
        for modality, contents in inputs.items():
            np.testing.assert_array_equal(
                model.encode(contents, modality=modality), eager[modality])
    assert {key[0] for key in model.graphs.graphs} == \
        {"text", "image", "audio", "video"}
    assert capture.captures == len(model.graphs.graphs) == 4


def test_languagebind_graphed_towers_match_jax(languagebind, monkeypatch):
    model, params, jconfigs = languagebind
    _card_graphed(monkeypatch, model)
    rng = np.random.default_rng(11)
    texts = rng.integers(1, 63, (3, model.text_config.max_positions))
    texts[np.arange(3), rng.integers(2, 20, 3)] = \
        model.text_config.eos_token_id
    arrays = {
        "text": texts.astype(np.int32),
        "image": rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8),
        "audio": rng.standard_normal((2, 128, 96)).astype(np.float32),
        "video": rng.integers(0, 256, (1, 3, 32, 32, 3), dtype=np.uint8)}
    jitted = {
        "text": lambda x: jclip.encode_clip_text_jit(
            params, x, jconfigs["text"], compute_dtype=F32),
        "image": lambda x: jclip.encode_clip_image_jit(
            params, x, jconfigs["image"], compute_dtype=F32),
        "audio": lambda x: jlb.encode_audio_tower_jit(
            params["audio"], x, jconfigs["audio"], compute_dtype=F32),
        "video": lambda x: jlb.encode_video_tower_jit(
            params["video"], x, jconfigs["video"], compute_dtype=F32)}
    for tower, array in arrays.items():
        out = model._run(tower, array)
        ref = np.asarray(jitted[tower](jnp.asarray(array)))
        assert out.shape == ref.shape == (len(array), 24)
        if tower == "video":
            np.testing.assert_allclose(out, ref, atol=3e-5)
        else:
            assert (_cosines(out, ref) > 1 - 1e-5).all()
            np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    assert {key[0]: key[2] for key in model.graphs.graphs} == {
        tower: (getattr(model.encoder, tlb.TOWERS[tower]).config,)
        for tower in arrays}


def test_languagebind_one_capture_a_key(languagebind, monkeypatch):
    """Texts and images key by their batch size (no bucket, as the JAX
    package compiles a program a shape), audio by its chunk count, video
    by nothing else: every video is one (1, T, size, size, 3) call."""
    model, _, _ = languagebind
    capture = _card_graphed(monkeypatch, model)
    for n in (1, 3, 1, 2):
        model.encode(TEXTS[:n])
        model.encode(_photos(n, seed=n), modality=Modality.IMAGE)
    for n in (1, 3, 2, 3):  # a document's 10 s chunks arrive as one batch
        model.encode(_waves(n, seed=n), modality=Modality.AUDIO)
    for n in (1, 3):
        model.encode(_videos(n, seed=n), modality=Modality.VIDEO)
    L, T = model.text_config.max_positions, model.video_config.num_frames
    assert _shapes(model.graphs) == (
        {("text", (n, L)) for n in (1, 2, 3)} |
        {("image", (n, 32, 32, 3)) for n in (1, 2, 3)} |
        {("audio", (n, 128, 96)) for n in (1, 2, 3)} |
        {("video", (1, T, 32, 32, 3))})
    assert capture.captures == len(model.graphs.graphs) == 10


def test_languagebind_twins_get_keys_of_their_own(languagebind,
                                                  monkeypatch):
    """``set_attention_impl`` replaces the towers' configs: the twins'
    forward is a key of its own, and each config replays its own."""
    model, _, _ = languagebind
    capture = _card_graphed(monkeypatch, model)
    images = _photos(2)
    kernel = model.encode(images, modality=Modality.IMAGE)
    try:
        model.set_attention_impl("plain")
        plain = model.encode(images, modality=Modality.IMAGE)
    finally:
        model.set_attention_impl("kernel")
    np.testing.assert_array_equal(
        model.encode(images, modality=Modality.IMAGE), kernel)
    # on the CPU the kernel's path is its twin
    np.testing.assert_array_equal(plain, kernel)
    impls = sorted(key[2][0].attention_impl for key in model.graphs.graphs)
    assert impls == ["kernel", "plain"] and capture.captures == 2


@pytest.mark.parametrize("tower", sorted(tlb.TOWERS))
def test_languagebind_tower_assigned_anew_is_not_served_stale(
        languagebind, monkeypatch, tower):
    """Capture a tower's key, assign a tower of the same config with other
    weights: the next call returns the new tower's eager result, through
    a new capture, never the old capture's replay."""
    model, _, _ = languagebind
    monkeypatch.setattr(model, "encoder", tlb.LanguageBindEncoder(
        **{name: getattr(model.encoder, name)
           for name in tlb.TOWERS.values()}))
    capture = _card_graphed(monkeypatch, model)
    modality = {"text": Modality.TEXT, "image": Modality.IMAGE,
                "audio": Modality.AUDIO, "video": Modality.VIDEO}[tower]
    contents = _lb_inputs()[modality]
    old = model.encode(contents, modality=modality)
    attribute = tlb.TOWERS[tower]
    module = getattr(model.encoder, attribute)
    fresh = _lb_model(f"graphs-lb-{tower}")
    if tower == "video":
        new = tlb.init_video_tower(module.config,
                                   torch.Generator().manual_seed(5),
                                   device="cpu")
    else:
        new = getattr(fresh.encoder, attribute)
    assert new.config == module.config and new is not module
    setattr(model.encoder, attribute, new)
    out = model.encode(contents, modality=modality)
    monkeypatch.setattr(batching, "card_graphs", lambda g: None)
    expected = model.encode(contents, modality=modality)
    np.testing.assert_array_equal(out, expected)
    assert np.abs(out - old).max() > 1e-3
    assert capture.captures == 2 and len(model.graphs.graphs) == 1
    (graph,) = model.graphs.graphs.values()
    assert graph.key[0] == tower


def test_languagebind_cpu_never_enters_the_graphs(languagebind,
                                                  monkeypatch):
    model, _, _ = languagebind
    monkeypatch.setattr(graphs.EncoderGraphs, "run", _refuse)
    assert batching.card_graphs(model.graphs) is None
    for modality, contents in _lb_inputs().items():
        out = model.encode(contents, modality=modality)
        assert out.shape == (len(contents), 24)


def test_forget_drops_only_that_towers_graphs():
    capture = StandIn()
    cache = graphs.EncoderGraphs("cpu", capture=capture)
    x = np.arange(6, dtype=np.int32).reshape(2, 3)
    for tower in ("audio", "video"):
        for rows in (1, 2):
            cache.run(tower, torch.float32, lambda a: a.float() + 1,
                      x[:rows])
    cache.forget("audio")
    assert {key[0] for key in cache.graphs} == {"video"} and \
        len(cache.graphs) == 2
    cache.run("audio", torch.float32, lambda a: a.float() + 1, x)
    assert capture.captures == 5
