"""The port's execution model: one CUDA graph per static bucket
(marqo_tpu_torch/inference/graphs.py), on the CPU.

(a) The packed path's static sequence bucket: the same numpy-seeded inputs
    through the JAX package's ``encode_tokens_packed_jit(...,
    num_sequences=n_bucket)`` and the port's ``encode_tokens_packed(...,
    n_bucket)[:n]``, fp32, within atol 2e-5 (tests/test_packing.py's
    tolerance); the loader's packed rows equal those of a pooling over
    exactly n sequences, below and at a bucket edge.
(b) ``EncoderGraphs``' cache through a stand-in for the capture, which
    computes the forward again from the static inputs on every replay: the
    key (tower, dtype, static values, input shapes, never the callable),
    one capture a key, a clone per replay, errors that raise, and the
    launches a capture records added on every replay.
(c) The routing: on the CPU the models never enter the module; where
    ``graphs_for`` gives a model its graphs, the text model's padded and
    packed paths and the ViT CLIP towers go through them and return the
    eager forward's rows.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.models import bert as jbert
from marqo_tpu.ops.packing import pack_sequences as jax_pack_sequences
from marqo_tpu_torch.inference import batching, graphs, loaders
from marqo_tpu_torch.inference.types import Device
from marqo_tpu_torch.models import bert as tbert
from marqo_tpu_torch.ops import launches
from marqo_tpu_torch.ops.packing import pack_sequences

SMALL = dict(vocab_size=100, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position_embeddings=64)
TEXT_PROPS = {"random_init": True, "pooling_method": "mean", "tokens": 64,
              "dimensions": 64,
              "architecture": {"vocab_size": 128, "hidden_size": 64,
                               "num_layers": 2, "num_heads": 4,
                               "intermediate_size": 128}}
CLIP_PROPS = {"type": "clip", "random_init": True, "dimensions": 16,
              "image_size": 32,
              "architecture": {"vocab_size": 256, "text_hidden_size": 32,
                               "text_layers": 1, "text_heads": 2,
                               "text_intermediate": 64, "patch_size": 16,
                               "vision_hidden_size": 32, "vision_layers": 2,
                               "vision_heads": 2,
                               "vision_intermediate": 64}}


# --- (a) the packed path's sequence bucket -----------------------------------

@pytest.fixture(scope="module")
def shared_weights():
    jconfig = jbert.TextEncoderConfig(**SMALL)
    tconfig = tbert.TextEncoderConfig(**SMALL)
    params = jbert.init_params(jconfig, jax.random.PRNGKey(0))
    numpy_params = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32),
                                params)
    return jconfig, tconfig, params, numpy_params


def _ragged(n, seed, max_len=30):
    rng = np.random.default_rng(seed)
    return [rng.integers(5, SMALL["vocab_size"], rng.integers(3, max_len))
            .astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("pooling", ["mean", "cls"])
@pytest.mark.parametrize("n", [5, 8, 9])
def test_packed_n_bucket_matches_the_jax_program(shared_weights, n,
                                                 pooling):
    """n = 5 and 9 pad the pooled rows to the buckets 8 and 16; n = 8 is
    at a bucket's edge."""
    jconfig, tconfig, params, numpy_params = shared_weights
    jconfig = replace(jconfig, pooling=pooling)
    tconfig = replace(tconfig, pooling=pooling)
    n_bucket = batching.pick_batch_bucket(n)
    assert n_bucket == {5: 8, 8: 8, 9: 16}[n]
    seqs = _ragged(n, seed=n)
    batch = jax_pack_sequences(seqs, seq_len=32)
    rows = (batch.input_ids, batch.segment_ids, batch.positions,
            batch.seq_index)
    ref = np.asarray(jbert.encode_tokens_packed_jit(
        params, *map(jnp.asarray, rows), n_bucket, jconfig,
        compute_dtype=jnp.float32))
    encoder = tbert.params_from_jax(numpy_params, tconfig, device="cpu")
    out = tbert.encode_tokens_packed(encoder, *map(torch.from_numpy, rows),
                                     n_bucket).numpy()
    assert ref.shape == out.shape == (n_bucket, SMALL["hidden_size"])
    np.testing.assert_allclose(out[:n], ref[:n], atol=2e-5)
    # the bucket's padding rows pool nothing
    assert not out[n:].any()


def _text_model():
    model = loaders.TorchHFTextModel("graphs-test-e5", dict(TEXT_PROPS),
                                     Device.CPU)
    model.load()
    return model


def _texts(n):
    """One long text and n - 1 short ones: dense enough to pack."""
    return [" ".join(["alpha"] * 40)] + [f"bravo {i}" for i in range(n - 1)]


@pytest.mark.parametrize("n", [5, 8])
def test_loader_packed_rows_are_those_of_n_sequences(n):
    """The loader pads the pooled rows to n_bucket and returns the first n:
    the same rows as a pooling over exactly n sequences, bit for bit."""
    model = _text_model()
    texts = _texts(n)
    calls = []
    packed = model._packed
    model._packed = lambda rows, n_bucket: calls.append(n_bucket) or \
        packed(rows, n_bucket)
    out = model.encode(texts, normalize=False)
    assert calls == [batching.pick_batch_bucket(n)]

    batch = model.tokenizer.encode_batch(texts)
    seq_bucket = batching.pick_seq_bucket(max(batch["lengths"]))
    sequences = [batch["input_ids"][i, :length]
                 for i, length in enumerate(batch["lengths"])]
    rows = pack_sequences(sequences, seq_len=seq_bucket,
                          pad_id=model.tokenizer.pad_id,
                          row_buckets=batching.row_buckets())
    with torch.inference_mode():
        before = tbert.encode_tokens_packed(
            model.encoder, *(torch.from_numpy(a) for a in (
                rows.input_ids, rows.segment_ids, rows.positions,
                rows.seq_index)), n).numpy()
    assert out.shape == (n, 64)
    np.testing.assert_array_equal(out, before)


# --- (b) the cache, through a stand-in capture -------------------------------

class StandIn:
    """A capture that computes the forward once (its launches recorded, as
    under a real capture) and again from the static inputs on every
    replay, into the static output, with the replay's own launches kept
    out of the counts, as a graph's are."""

    def __init__(self, fail_capture=False, fail_replay=False):
        self.captures = 0
        self.fail_capture = fail_capture
        self.fail_replay = fail_replay

    def __call__(self, forward, inputs):
        self.captures += 1
        if self.fail_capture:
            raise RuntimeError("capture failed")
        output = forward(*inputs)

        def replay():
            if self.fail_replay:
                raise RuntimeError("replay failed")
            with launches.recording():
                output.copy_(forward(*inputs))

        return replay, output


COUNTS = {"kernel": 0}


def _forward(x):
    """x * 2 + 1, counted as one launch of a kernel named "toy"."""
    launches.count(launches.Launch(COUNTS, "kernel", None, None, "toy",
                                   tuple(x.shape)))
    return x.float() * 2 + 1


def _x(seed, shape=(4, 3), dtype=np.int32):
    return np.random.default_rng(seed).integers(0, 9, shape).astype(dtype)


def test_keys_are_tower_dtype_static_and_shapes_never_the_callable():
    capture = StandIn()
    cache = graphs.EncoderGraphs("cpu", capture=capture)
    bf16 = torch.bfloat16
    for _ in range(3):  # a new lambda each call: still one key
        cache.run("text", bf16, lambda x: _forward(x), _x(0))
    assert capture.captures == 1
    cache.run("vision", bf16, _forward, _x(0))
    cache.run("text", torch.float32, _forward, _x(0))
    cache.run("text", bf16, _forward, _x(0, shape=(8, 3)))
    cache.run("text", bf16, _forward, _x(0, dtype=np.int64))
    cache.run("text", bf16, _forward, _x(0), static=("plain",))
    assert capture.captures == 6 == len(cache.graphs)
    for _ in range(2):  # every key again: replays only
        cache.run("vision", bf16, _forward, _x(1))
        cache.run("text", bf16, _forward, _x(1), static=("plain",))
    assert capture.captures == 6


def test_replays_read_the_static_inputs_and_return_clones():
    cache = graphs.EncoderGraphs("cpu", capture=StandIn())
    first, second = _x(1), _x(2)
    out1 = cache.run("text", torch.bfloat16, _forward, first)
    out2 = cache.run("text", torch.bfloat16, _forward, second)
    (graph,) = cache.graphs.values()
    assert out1 is not graph.output and out2 is not graph.output
    assert torch.equal(out1, torch.from_numpy(first).float() * 2 + 1)
    assert torch.equal(out2, torch.from_numpy(second).float() * 2 + 1)
    assert torch.equal(graph.inputs[0], torch.from_numpy(second))


@pytest.mark.parametrize("failing", ["capture", "replay"])
def test_an_error_raises_and_gives_no_eager_result(failing):
    capture = StandIn(fail_capture=failing == "capture",
                      fail_replay=failing == "replay")
    cache = graphs.EncoderGraphs("cpu", capture=capture)
    for _ in range(2):  # and again: no result ever comes back
        with pytest.raises(RuntimeError, match=f"{failing} failed"):
            cache.run("text", torch.bfloat16, _forward, _x(0))
    # a failed capture keeps no graph and is tried again; a captured graph
    # whose replay fails stays
    assert capture.captures == (2 if failing == "capture" else 1)
    assert len(cache.graphs) == (0 if failing == "capture" else 1)


def test_recorded_launches_are_added_on_every_replay():
    cache = graphs.EncoderGraphs("cpu", capture=StandIn())
    before = COUNTS["kernel"]
    cache.run("text", torch.bfloat16, _forward, _x(0))
    # the warm run launched once, the capture recorded once and the replay
    # added it
    assert COUNTS["kernel"] == before + 2
    (graph,) = cache.graphs.values()
    assert [(launch.name, launch.shape) for launch in graph.launches] == \
        [("toy", (4, 3))]
    for i in range(3):
        cache.run("text", torch.bfloat16, _forward, _x(i))
    assert COUNTS["kernel"] == before + 5


def test_recording_keeps_launches_out_of_the_counts():
    before = COUNTS["kernel"]
    with launches.recording() as recorded:
        _forward(torch.zeros(2))
        _forward(torch.zeros(3))
    assert COUNTS["kernel"] == before
    assert [launch.shape for launch in recorded] == [(2,), (3,)]
    launches.add(recorded)
    assert COUNTS["kernel"] == before + 2


# --- (c) routing -------------------------------------------------------------

def _refuse(*args, **kwargs):
    raise AssertionError("the CPU path entered EncoderGraphs.run")


def test_cpu_models_never_enter_the_graphs(monkeypatch):
    from marqo_tpu_torch.models.clip import TorchCLIPModel
    monkeypatch.setattr(graphs.EncoderGraphs, "run", _refuse)
    model = _text_model()
    assert batching.graphs_for(model) is None
    assert model.encode(_texts(6)).shape == (6, 64)      # packed
    assert model.encode(["one query"]).shape == (1, 64)  # padded
    assert model.warmup([[1, 16], [8, 32]]) == 2
    clip = TorchCLIPModel("graphs-test-clip", dict(CLIP_PROPS), Device.CPU)
    clip.load()
    assert batching.graphs_for(clip) is None
    assert clip.encode(["a photo"]).shape == (1, 16)
    assert clip.warmup(images=2) == 4


def _graphed(monkeypatch, model):
    """Give ``model`` its graphs on the CPU, captured by the stand-in."""
    capture = StandIn()
    model.graphs = graphs.EncoderGraphs("cpu", capture=capture)
    for module in (batching, loaders):
        monkeypatch.setattr(module, "graphs_for",
                            lambda m: m.graphs if m is model else None)
    return capture


def test_text_model_replays_its_padded_and_packed_graphs(monkeypatch):
    eager = _text_model()
    model = _text_model()
    capture = _graphed(monkeypatch, model)
    for texts in (["one query"], _texts(6), ["another query"], _texts(7)):
        np.testing.assert_array_equal(model.encode(texts),
                                      eager.encode(texts))
    towers = sorted(key[0] for key in model.graphs.graphs)
    # one padded key (batch 1 at seq 16), one packed key (rows, seq 64,
    # n_bucket 8) for 6 and 7 texts
    assert towers == ["packed", "padded"] and capture.captures == 2
    # the config is part of the key: the twin's forward is a new graph
    model.encoder.config = replace(model.encoder.config,
                                   attention_impl="plain")
    np.testing.assert_array_equal(model.encode(["one query"]),
                                  eager.encode(["one query"]))
    assert capture.captures == 3
    assert model.warmup([[1, 16], [8, 32]]) == 2
    assert capture.captures == 4  # (1, 16) was there; (8, 32) is new


def test_clip_towers_replay_their_graphs(monkeypatch):
    from marqo_tpu_torch.models.clip import TorchCLIPModel
    eager = TorchCLIPModel("graphs-test-clip", dict(CLIP_PROPS), Device.CPU)
    eager.load()
    model = TorchCLIPModel("graphs-test-clip", dict(CLIP_PROPS), Device.CPU)
    model.load()
    capture = _graphed(monkeypatch, model)
    assert model.warmup(images=8) == 4
    assert sorted(key[0] for key in model.graphs.graphs) == \
        ["text", "text", "vision", "vision"]
    rng = np.random.default_rng(3)
    pixels = rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    np.testing.assert_array_equal(model._run(pixels, "vision"),
                                  eager._run(pixels, "vision"))
    texts = ["a red photo", "a green photo", "blue"]
    np.testing.assert_array_equal(model.encode(texts), eager.encode(texts))
    assert capture.captures == 4  # 5 images and 3 texts take bucket 8


RN50_PROPS = {"type": "open_clip", "random_init": True, "dimensions": 16,
              "image_size": 64,
              "architecture": {"vocab_size": 256, "text_hidden_size": 32,
                               "text_layers": 1, "text_heads": 2,
                               "text_intermediate": 64, "width": 16,
                               "heads": 2}}
XLMR_PROPS = {"type": "open_clip", "random_init": True, "dimensions": 16,
              "image_size": 32, "architecture": {"vocab_size": 256}}


def test_eager_clip_subclasses_keep_their_towers_eager(monkeypatch):
    """The CLIP subclasses that ran eagerly before, ConvCLIPModel's (the
    ResNet and ConvNeXt towers) and TorchHFCLIPModel (XLM-R text), now
    replay their graphs as TorchCLIPModel does: no ``GRAPHED`` flag is
    left, the inherited ``warmup`` captures both towers' buckets and
    ``encode`` returns the eager rows."""
    from marqo_tpu_torch.models.clip import TorchCLIPModel
    from marqo_tpu_torch.models.hf_clip import TorchHFCLIPModel
    from marqo_tpu_torch.models.resnet_clip import TorchResNetCLIPModel
    assert not hasattr(TorchCLIPModel, "GRAPHED")
    for cls, props in ((TorchResNetCLIPModel, RN50_PROPS),
                       (TorchHFCLIPModel, XLMR_PROPS)):
        assert not hasattr(cls, "GRAPHED")
        eager = cls(f"graphs-test-{cls.__name__}", dict(props), Device.CPU)
        eager.load()
        model = cls(f"graphs-test-{cls.__name__}", dict(props), Device.CPU)
        model.load()
        capture = _graphed(monkeypatch, model)
        assert model.warmup(images=8) == 4
        assert sorted(key[0] for key in model.graphs.graphs) == \
            ["text", "text", "vision", "vision"] and capture.captures == 4
        size = props["image_size"]
        pixels = np.random.default_rng(4).integers(
            0, 256, (5, size, size, 3), dtype=np.uint8)
        np.testing.assert_array_equal(model._run(pixels, "vision"),
                                      eager._run(pixels, "vision"))
        texts = ["a red photo", "a green photo", "blue"]
        np.testing.assert_array_equal(model.encode(texts),
                                      eager.encode(texts))
