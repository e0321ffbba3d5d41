"""DeepSeek-V2 as a mean-pooled text embedder (models/deepseek_v2.py,
ops/moe.py, B1's causal modes), on the CPU at a tiny ``deepseek_v2``
config with YaRN on and seeded random weights:

- the plain reference (tests/reference/deepseek_v2.py) against
  transformers' ``DeepseekV2Model``, mean-pooled: the reference held to the
  published equations;
- the port's eager forward, padded and packed, against the reference;
- B1's causal twin against a plain masked softmax at Dqk != Dv;
- the expert layer against a per-token loop;
- a stand-in CUDA graph of one key, replayed bit for bit, and the
  ``moe.expert_tokens`` counter;
- the ``hf`` type's dispatch, sharded loading, and the HTTP API end to end.
"""

import filecmp
import json
import math
import os

import numpy as np
import pytest
import torch

from marqo_tpu_torch.inference import batching, graphs, loaders
from marqo_tpu_torch.inference.types import Device
from marqo_tpu_torch.models import deepseek_v2 as dsv2
from marqo_tpu_torch.ops import flash_attention as fa
from marqo_tpu_torch.ops import moe
from marqo_tpu_torch.ops.packing import pack_sequences
from tests.deepseek_v2_checkpoint import (TINY, state_dict,
                                          write_checkpoint)
from tests.reference import deepseek_v2 as ref
from tests.test_torch_encoder_graphs import StandIn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def load(sd: dict, dtype=torch.float32):
    """The port's model of ``sd`` on the CPU, read tensor by tensor."""
    model = dsv2.empty_model(dsv2.config_from_hf(TINY), dtype, "cpu")
    return dsv2.load_tensors(model, ((name, (lambda t=t: t))
                                     for name, t in sd.items()))


def port_model(sd: dict = None, dtype=torch.float32):
    return load(state_dict() if sd is None else sd, dtype)


def rows(seed: int = 1, lengths=(9, 17, 3, 12)):
    """Right-padded (B, S) ids and mask of sequences of ``lengths``."""
    rng = np.random.default_rng(seed)
    S = max(lengths)
    ids = np.zeros((len(lengths), S), dtype=np.int64)
    mask = np.zeros((len(lengths), S), dtype=np.int64)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(0, TINY["vocab_size"], n)
        mask[i, :n] = 1
    return torch.from_numpy(ids), torch.from_numpy(mask)


def reference_vectors(tmp_path, ids, mask, sd=None):
    directory = write_checkpoint(str(tmp_path / "ref"), sd)
    weights = ref.Weights(directory, "cpu")
    with torch.no_grad():
        return ref.encode(weights, ref.read_config(directory), ids, mask)


def cosine(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return (torch.nn.functional.normalize(a, dim=-1) *
            torch.nn.functional.normalize(b, dim=-1)).sum(-1)


# --- the reference held to transformers -----------------------------------------

def test_reference_matches_transformers_deepseek_v2(tmp_path):
    from transformers import DeepseekV2Config, DeepseekV2Model
    sd = state_dict()
    config = DeepseekV2Config(**{k: v for k, v in TINY.items()
                                 if k not in ("model_type", "architectures")})
    config._attn_implementation = "eager"
    model = DeepseekV2Model(config).eval()
    missing, unexpected = model.load_state_dict(
        {k[len("model."):]: v for k, v in sd.items()
         if k.startswith("model.")}, strict=False)
    assert not missing and not unexpected
    # transformers' DeepseekV2Attention leaves out DeepSeek's mscale^2 on
    # the softmax scale (the reference's first noted departure)
    _, _, scale = ref.yarn(TINY)
    for layer in model.layers:
        layer.self_attn.scaling = scale
    ids, mask = rows()
    with torch.no_grad():
        hidden = model(input_ids=ids, attention_mask=mask).last_hidden_state
    m = mask.float()[..., None]
    expected = torch.nn.functional.normalize((hidden * m).sum(1) / m.sum(1),
                                             dim=-1)
    got = reference_vectors(tmp_path, ids, mask, sd)
    torch.testing.assert_close(got, expected, atol=2e-6, rtol=0)
    assert scale == pytest.approx((0.1 * 0.707 * math.log(40) + 1) ** 2 /
                                  math.sqrt(24))
    # the scale matters: transformers' own gives vectors the tolerance sees
    for layer in model.layers:
        layer.self_attn.scaling = 24 ** -0.5
    with torch.no_grad():
        hidden = model(input_ids=ids, attention_mask=mask).last_hidden_state
    plain = torch.nn.functional.normalize((hidden * m).sum(1) / m.sum(1),
                                          dim=-1)
    assert float((plain - got).abs().max()) > 1e-3


# --- the port held to the reference ----------------------------------------------

@pytest.mark.parametrize("path", ["padded", "packed"])
def test_port_matches_reference(tmp_path, path):
    ids, mask = rows()
    expected = reference_vectors(tmp_path, ids, mask)
    model = port_model()
    with torch.inference_mode():
        if path == "padded":
            got = dsv2.encode_tokens(model, ids, mask)
        else:
            lengths = mask.sum(1).tolist()
            packed = pack_sequences([ids[i, :n].tolist()
                                     for i, n in enumerate(lengths)],
                                    seq_len=32, row_buckets=[2, 4])
            got = dsv2.encode_tokens_packed(
                model, *(torch.from_numpy(a) for a in (
                    packed.input_ids, packed.segment_ids, packed.positions,
                    packed.seq_index)), len(lengths))
    assert float(cosine(got, expected).min()) > 1 - 1e-5


def test_packed_matches_padded():
    ids, mask = rows(seed=3, lengths=(5, 20, 11, 1, 14, 8))
    model = port_model()
    lengths = mask.sum(1).tolist()
    packed = pack_sequences([ids[i, :n].tolist()
                             for i, n in enumerate(lengths)],
                            seq_len=32, row_buckets=[4])
    with torch.inference_mode():
        padded = dsv2.encode_tokens(model, ids, mask)
        got = dsv2.encode_tokens_packed(
            model, *(torch.from_numpy(a) for a in (
                packed.input_ids, packed.segment_ids, packed.positions,
                packed.seq_index)), len(lengths))
    torch.testing.assert_close(got, padded, atol=2e-5, rtol=0)


def test_bf16_port_is_near_the_reference(tmp_path):
    """The served dtype on the CPU: bf16 stays close, and a wrong softmax
    scale does not."""
    ids, mask = rows(seed=5)
    expected = reference_vectors(tmp_path, ids, mask)
    with torch.inference_mode():
        got = dsv2.encode_tokens(port_model(dtype=torch.bfloat16), ids, mask)
    assert float(cosine(got, expected).min()) > 0.999


# --- B1's causal modes ------------------------------------------------------------

def plain_causal(q, k, v, allowed_key, scale):
    """A loop over rows and queries: softmax over the allowed keys j <= i
    (a row with none: the uniform mean of V over every key)."""
    B, N, S, _ = q.shape
    out = torch.empty(B, N, S, v.shape[-1])
    for b in range(B):
        for i in range(S):
            keys = [j for j in range(i + 1) if allowed_key(b, i, j)]
            if not keys:
                out[b, :, i] = v[b].float().mean(1)
                continue
            s = (q[b, :, i:i + 1].float() @ k[b, :, keys].float()
                 .transpose(-1, -2)) * scale
            out[b, :, i] = (torch.softmax(s, -1) @ v[b, :, keys].float())[:, 0]
    return out


@pytest.mark.parametrize("mode", ["padding", "segment"])
def test_causal_twin_matches_a_plain_masked_softmax(mode):
    g = torch.Generator().manual_seed(7)
    B, N, S = 3, 2, 11
    q = torch.randn(B, N, S, 24, generator=g)
    k = torch.randn(B, N, S, 24, generator=g)
    v = torch.randn(B, N, S, 16, generator=g)
    scale = 0.3
    if mode == "padding":
        lengths = [11, 6, 1]
        mask = torch.tensor([[1] * n + [0] * (S - n) for n in lengths])
        got = fa.attention_padding(q, k, v, mask, causal=True, scale=scale)

        def allowed(b, i, j):
            return mask[b, j] > 0
    else:
        mask = torch.tensor([[1, 1, 1, 2, 2, 3, 3, 3, 3, 0, 0],
                             [1] * 11,
                             [1, 2, 3, 4, 5, 6, 7, 0, 0, 0, 0]])
        got = fa.attention_segment(q, k, v, mask, causal=True, scale=scale)

        def allowed(b, i, j):
            return mask[b, j] > 0 and mask[b, j] == mask[b, i]
    assert got.shape == (B, N, S, 16)
    expected = plain_causal(q, k, v, allowed, scale)
    torch.testing.assert_close(got, expected, atol=1e-5, rtol=0)


def test_causal_launch_refuses_other_head_dims():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="causal modes take"):
        fa._launch_causal(q, q, q, torch.ones(1, 8), "padding")


# --- the expert layer -------------------------------------------------------------

def per_token_experts(x, valid, router, gate_up, down, top_k):
    """Each token on its own: softmax over the routed experts, its top k
    weighted."""
    F = down.shape[2]
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        if not valid[t]:
            continue
        probs = torch.softmax(x[t].float() @ router.float().T, -1)
        weights, chosen = torch.topk(probs, top_k)
        for e, w in zip(chosen.tolist(), weights.tolist()):
            h = gate_up[e] @ x[t]
            y = down[e] @ (torch.nn.functional.silu(h[:F]) * h[F:])
            out[t] += w * y
    return out


def test_expert_layer_matches_a_per_token_loop():
    g = torch.Generator().manual_seed(11)
    T, H, F, E, k = 40, 16, 8, 6, 2
    x = torch.randn(T, H, generator=g)
    x[:, 0] = 1.0
    router = torch.randn(E, H, generator=g)
    router[3] = 0.0
    router[3, 0] = -50.0  # expert 3: no token
    gate_up = torch.randn(E, 2 * F, H, generator=g) * 0.3
    down = torch.randn(E, H, F, generator=g) * 0.3
    valid = torch.ones(T, dtype=torch.bool)
    valid[[5, 17, 39]] = False
    counts = torch.zeros(E, dtype=torch.int64)
    got = moe.expert_layer(x, valid, router, gate_up, down, k, counts=counts)
    expected = per_token_experts(x, valid, router, gate_up, down, k)
    torch.testing.assert_close(got, expected, atol=1e-5, rtol=0)
    assert counts[3] == 0
    assert int(counts.sum()) == int(valid.sum()) * k
    assert not got[~valid].any()


def test_grouped_mm_twin_skips_rows_past_the_last_group():
    rows_ = torch.arange(12.0).view(6, 2)
    weight = torch.stack([torch.eye(2), 2 * torch.eye(2), 3 * torch.eye(2)])
    out = moe.grouped_mm_reference(rows_, weight,
                                   torch.tensor([2, 2, 5], dtype=torch.int32))
    torch.testing.assert_close(out[:2], rows_[:2])
    torch.testing.assert_close(out[2:5], 3 * rows_[2:5])
    assert not out[5].any()


# --- the model class: dispatch, loading, graphs, counters ---------------------------

def _props(directory):
    return {"type": "hf", "localpath": directory, "dimensions": 64,
            "tokens": 64, "pooling_method": "mean"}


def test_hf_type_dispatches_on_the_checkpoints_model_type(tmp_path):
    bert = tmp_path / "bert"
    bert.mkdir()
    (bert / "config.json").write_text(json.dumps({"model_type": "bert"}))
    decoder = write_checkpoint(str(tmp_path / "dsv2"))
    assert loaders.resolve_model_class(
        "m", {"type": "hf", "localpath": str(bert)}) is \
        loaders.TorchHFTextModel
    assert loaders.resolve_model_class("m", {"type": "hf"}) is \
        loaders.TorchHFTextModel
    assert loaders.resolve_model_class("m", _props(decoder)) is \
        loaders.TorchDeepseekV2Model


def test_sharded_checkpoint_loads_the_same_tensors(tmp_path):
    sd = state_dict()
    config = dsv2.config_from_hf(TINY)
    models = []
    for shards in (0, 3):
        directory = write_checkpoint(str(tmp_path / f"s{shards}"), sd, shards)
        models.append(dsv2.load_tensors(
            dsv2.empty_model(config, torch.float32, "cpu"),
            loaders.checkpoint_tensors(directory)))
    whole, sharded = (dict(m.named_parameters()) for m in models)
    assert whole.keys() == sharded.keys()
    for name in whole:
        assert torch.equal(whole[name], sharded[name]), name
    # and what they hold is the state dict
    expected = port_model(sd)
    for name, tensor in expected.named_parameters():
        assert torch.equal(whole[name], tensor), name


def test_missing_tensor_is_an_error(tmp_path):
    sd = state_dict()
    del sd["model.layers.2.mlp.experts.5.up_proj.weight"]
    with pytest.raises(KeyError, match="experts.5.up_proj"):
        load(sd)


def _loaded(tmp_path):
    directory = write_checkpoint(str(tmp_path / "ckpt"))
    model = loaders.load_model("dsv2-test", dict(_props(directory),
                                                 name="dsv2-test"), Device.CPU)
    assert isinstance(model, loaders.TorchDeepseekV2Model)
    return model


def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join("w" + str(rng.integers(0, 50))
                     for _ in range(int(rng.integers(2, 12))))
            for _ in range(n)]


def test_graphed_key_replays_bit_for_bit_and_counts_expert_tokens(
        tmp_path, monkeypatch):
    from marqo_tpu_torch.api import telemetry
    eager = _loaded(tmp_path)
    model = _loaded(tmp_path)
    model.graphs = graphs.EncoderGraphs("cpu", capture=StandIn())
    for module in (batching, loaders):
        monkeypatch.setattr(module, "graphs_for",
                            lambda m: m.graphs if m is model else None)
    texts = _texts(9)
    first = model.encode(texts)           # packed: capture, then replay
    assert len(model.graphs.graphs) == 1
    before = model.encoder.expert_tokens.clone()
    again = model.encode(texts)           # replay of the captured key
    np.testing.assert_array_equal(first, again)
    np.testing.assert_array_equal(again, eager.encode(texts))
    tokens = sum(min(len(t.encode()) + 1, 64) for t in texts)
    delta = model.encoder.expert_tokens - before
    assert delta.shape == (2, TINY["n_routed_experts"])
    assert delta.sum(1).tolist() == [tokens * TINY["num_experts_per_tok"]] * 2

    # a traced request reads the buffer at its device wait (keys captured
    # before: a capture's warm run counts its tokens too)
    model.encode(texts[:1])
    metrics = telemetry.RequestMetricsStore.set_in_request(traced=True)
    try:
        model.encode(texts)
        model.encode(texts[:1])           # padded
    finally:
        telemetry.RequestMetricsStore.clear()
    assert metrics.counters["moe.forwards"] == 2
    logged = [e for e in telemetry.counts("moe.expert_tokens")
              if e.request == metrics.request_id]
    assert len(logged) == 2 and logged[1].values.shape == (2, 8)
    assert logged[1].values.sum(1).tolist() == \
        [(len(texts[0].encode()) + 1) * TINY["num_experts_per_tok"]] * 2


def test_http_api_end_to_end(tmp_path, monkeypatch):
    """An index over a deepseek_v2 checkpoint through the port's HTTP API:
    create, add (packed), search, embed; the stored vectors are the
    reference's."""
    import urllib.request
    directory = write_checkpoint(str(tmp_path / "ckpt"))
    monkeypatch.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")
    monkeypatch.setenv("MARQO_MODELS_TO_PRELOAD", "[]")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    from marqo_tpu_torch.api.app import build_app, generate_config, on_start
    from marqo_tpu_torch.api.http_framework import serve
    config = generate_config()
    on_start(config)
    server = serve(build_app(config), host="127.0.0.1", port=0,
                   background=True)
    port = server.server_address[1]

    def call(method, path, body=None):
        r = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"})
        return json.load(urllib.request.urlopen(r))

    try:
        call("POST", "/indexes/dsv2", {
            "model": "dsv2-e2e", "modelProperties": _props(directory),
            "type": "unstructured",
            "textPreprocessing": {"splitLength": 6, "splitOverlap": 0,
                                  "splitMethod": "sentence"}})
        docs = [{"_id": str(i), "title": t, "body": b} for i, (t, b) in
                enumerate(zip(_texts(5, 1), _texts(5, 2)))]
        added = call("POST", "/indexes/dsv2/documents?telemetry=true",
                     {"documents": docs, "tensorFields": ["title", "body"]})
        assert not added["errors"]
        assert added["telemetry"]["counter"]["moe.forwards"] >= 1
        hits = call("POST", "/indexes/dsv2/search",
                    {"q": docs[2]["title"], "searchableAttributes": ["title"]})
        assert hits["hits"][0]["_id"] == "2"
        embedded = call("POST", "/indexes/dsv2/embed",
                        {"content": [docs[0]["title"]]})
        stored = call("GET", "/indexes/dsv2/documents/0?expose_facets=true")
    finally:
        server.shutdown()
        server.server_close()
    tok = loaders.TextTokenizer.from_pretrained(directory, max_length=64)
    batch = tok.encode_batch([docs[0]["title"]])
    expected = reference_vectors(
        tmp_path, torch.from_numpy(batch["input_ids"]).long(),
        torch.from_numpy(batch["attention_mask"]).long())[0]
    facet = next(f for f in stored["_tensor_facets"] if "title" in f)
    assert float(cosine(facet["_embedding"], expected)) > 0.999
    assert float(cosine(embedded["embeddings"][0], expected)) > 0.999


def test_reference_copies_are_identical():
    assert filecmp.cmp(os.path.join(REPO, "tests", "reference",
                                    "deepseek_v2.py"),
                       os.path.join(REPO, "benchmark", "reference",
                                    "deepseek_v2.py"), shallow=False)
