"""marqo_tpu_torch's BERT encoder (models/bert.py) against marqo_tpu's.

The same weights go to both packages: marqo_tpu's parameter pytree through
``params_from_jax``, or one HF torch state dict through each package's
``params_from_torch_state_dict``. Inputs are made with numpy from a seed.
Tolerances are the JAX package's own (tests/test_bert_parity.py,
tests/test_packing.py): fp32 cosine > 1 - 1e-5, bf16 cosine > 1 - 1e-3,
packed against padded atol 2e-5.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.models import bert as jbert
from marqo_tpu.ops.packing import pack_sequences
from marqo_tpu_torch.models import bert as tbert

SMALL = dict(vocab_size=100, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position_embeddings=64)


def _configs(**overrides):
    return (jbert.TextEncoderConfig(**SMALL, **overrides),
            tbert.TextEncoderConfig(**SMALL, **overrides))


def _numpy_tree(params):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), params)


def _inputs(B=6, S=32, seed=0, vocab=100):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, S + 1, B)
    lengths[0] = S
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
    ids = (rng.integers(5, vocab, (B, S)) * mask).astype(np.int32)
    return ids, mask, lengths


def _cosines(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) *
                              np.linalg.norm(b, axis=-1))


@pytest.fixture(scope="module")
def shared_weights():
    jconfig, tconfig = _configs()
    params = jbert.init_params(jconfig, jax.random.PRNGKey(0))
    return jconfig, tconfig, params, _numpy_tree(params)


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_encode_tokens_fp32(shared_weights, pooling):
    jconfig, tconfig, params, params_np = shared_weights
    jconfig = replace(jconfig, pooling=pooling)
    tconfig = replace(tconfig, pooling=pooling)
    ids, mask, _ = _inputs()
    ref = jbert.encode_tokens(params, jnp.asarray(ids), jnp.asarray(mask),
                              jconfig, compute_dtype=jnp.float32)
    encoder = tbert.params_from_jax(params_np, tconfig, device="cpu")
    out = tbert.encode_tokens(encoder, torch.from_numpy(ids),
                              torch.from_numpy(mask))
    assert out.dtype == torch.float32 and tuple(out.shape) == (6, 64)
    assert (_cosines(out.numpy(), ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_encode_tokens_bf16(shared_weights):
    """Both packages in bf16, each the way its loader runs it (weights and
    compute in bf16)."""
    jconfig, tconfig, params, params_np = shared_weights
    ids, mask, _ = _inputs(seed=1)
    params16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    ref = jbert.encode_tokens(params16, jnp.asarray(ids), jnp.asarray(mask),
                              jconfig, compute_dtype=jnp.bfloat16)
    encoder = tbert.params_from_jax(params_np, tconfig, dtype=torch.bfloat16,
                                     device="cpu")
    out = tbert.encode_tokens(encoder, torch.from_numpy(ids),
                              torch.from_numpy(mask))
    assert out.dtype == torch.float32
    assert (_cosines(out.numpy(), ref) > 1 - 1e-3).all()


def _packed(ids, lengths, S):
    seqs = [ids[i, :lengths[i]] for i in range(len(lengths))]
    return pack_sequences(seqs, seq_len=S, pad_id=0)


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_encode_tokens_packed_fp32(shared_weights, pooling):
    jconfig, tconfig, params, params_np = shared_weights
    jconfig = replace(jconfig, pooling=pooling)
    tconfig = replace(tconfig, pooling=pooling)
    ids, mask, lengths = _inputs(B=9, seed=2)
    packed = _packed(ids, lengths, 32)
    assert packed.input_ids.shape[0] < 9  # several documents share rows
    arrays = (packed.input_ids, packed.segment_ids, packed.positions,
              packed.seq_index)
    ref = jbert.encode_tokens_packed(params, *map(jnp.asarray, arrays),
                                     packed.n_sequences, jconfig,
                                     compute_dtype=jnp.float32)
    encoder = tbert.params_from_jax(params_np, tconfig, device="cpu")
    out = tbert.encode_tokens_packed(encoder, *map(torch.from_numpy, arrays),
                                     packed.n_sequences).numpy()
    assert out.shape == (9, 64)
    assert (_cosines(out, ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)
    # packed equals padded (tests/test_packing.py:101)
    padded = tbert.encode_tokens(encoder, torch.from_numpy(ids),
                                 torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, padded, atol=2e-5)


def test_packed_trash_row_takes_pad_tokens(shared_weights):
    """seq_index == -1 (pad tokens) pools into the trash row, never into a
    document."""
    _, tconfig, _, params_np = shared_weights
    encoder = tbert.params_from_jax(params_np, tconfig, device="cpu")
    ids, mask, lengths = _inputs(B=4, seed=5)
    packed = _packed(ids, lengths, 64)
    assert (packed.seq_index < 0).any()
    arrays = [torch.from_numpy(a) for a in (
        packed.input_ids, packed.segment_ids, packed.positions,
        packed.seq_index)]
    out = tbert.encode_tokens_packed(encoder, *arrays, packed.n_sequences)
    alone = [tbert.encode_tokens(
        encoder, torch.from_numpy(ids[i:i + 1, :lengths[i]]),
        torch.from_numpy(mask[i:i + 1, :lengths[i]])) for i in range(4)]
    np.testing.assert_allclose(out.numpy(), torch.cat(alone).numpy(),
                               atol=2e-5)


def test_normalize_gives_unit_vectors(shared_weights):
    _, tconfig, _, params_np = shared_weights
    encoder = tbert.params_from_jax(params_np, replace(tconfig, normalize=True),
                                    device="cpu")
    ids, mask, _ = _inputs(seed=3)
    out = tbert.encode_tokens(encoder, torch.from_numpy(ids),
                              torch.from_numpy(mask))
    np.testing.assert_allclose(out.norm(dim=-1).numpy(), 1.0, atol=1e-6)


def test_plain_attention_impl_matches_kernel_route_on_cpu(shared_weights):
    """On the CPU both attention_impl values reach the same plain twin."""
    _, tconfig, _, params_np = shared_weights
    ids, mask, _ = _inputs(seed=4)
    outs = []
    for impl in ("kernel", "plain"):
        encoder = tbert.params_from_jax(
            params_np, replace(tconfig, attention_impl=impl), device="cpu")
        outs.append(tbert.encode_tokens(encoder, torch.from_numpy(ids),
                                        torch.from_numpy(mask)))
    assert torch.equal(outs[0], outs[1])


def test_init_encoder_is_seeded():
    _, tconfig = _configs()
    a = tbert.init_encoder(tconfig, torch.Generator().manual_seed(5),
                           device="cpu")
    b = tbert.init_encoder(tconfig, torch.Generator().manual_seed(5),
                           device="cpu")
    c = tbert.init_encoder(tconfig, torch.Generator().manual_seed(6),
                           device="cpu")
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith(".weight") and not name.endswith("ln.weight"):
            assert not torch.equal(pa, pc), name
            assert abs(float(pa.std()) - 0.02) < 0.01, name


def _hf_model(kind):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    if kind == "bert":
        cfg = transformers.BertConfig(
            vocab_size=100, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=64)
        model = transformers.BertModel(cfg)
    else:
        cfg = transformers.XLMRobertaConfig(
            vocab_size=100, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=72, pad_token_id=1, type_vocab_size=1)
        model = transformers.XLMRobertaModel(cfg)
    return cfg, model.eval()


@pytest.mark.parametrize("kind", ["bert", "xlm-roberta"])
def test_params_from_torch_state_dict_matches_jax(kind):
    cfg, model = _hf_model(kind)
    state_dict = model.state_dict()
    jconfig = jbert.config_from_hf(cfg)
    tconfig = tbert.config_from_hf(cfg)
    assert tconfig.position_offset == jconfig.position_offset == (
        2 if kind == "xlm-roberta" else 0)
    jparams = jbert.params_from_torch_state_dict(state_dict, jconfig)
    encoder = tbert.params_from_torch_state_dict(state_dict, tconfig,
                                                 device="cpu")
    ids, mask, _ = _inputs(seed=6)
    ref = jbert.encode_tokens(jparams, jnp.asarray(ids), jnp.asarray(mask),
                              jconfig, compute_dtype=jnp.float32)
    out = tbert.encode_tokens(encoder, torch.from_numpy(ids),
                              torch.from_numpy(mask)).numpy()
    assert (_cosines(out, ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)


def test_params_from_torch_state_dict_matches_hf_bert_mean_pool():
    """The port against HF's own BertModel forward (mean pooling)."""
    cfg, model = _hf_model("bert")
    encoder = tbert.params_from_torch_state_dict(model.state_dict(),
                                                 tbert.config_from_hf(cfg),
                                                 device="cpu")
    ids, mask, _ = _inputs(seed=7)
    with torch.no_grad():
        hidden = model(input_ids=torch.from_numpy(ids).long(),
                       attention_mask=torch.from_numpy(mask).long()
                       ).last_hidden_state
    m = torch.from_numpy(mask).float()[..., None]
    ref = (hidden * m).sum(1) / m.sum(1)
    ref = ref / ref.norm(dim=-1, keepdim=True)  # config_from_hf normalizes
    out = tbert.encode_tokens(encoder, torch.from_numpy(ids),
                              torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


# --- int8 (W8A8) encoder: ops/quant.py, kernel B3's twin on the CPU ----------

@pytest.fixture(scope="module")
def quantized_weights(shared_weights):
    """marqo_tpu's quantized pytree (quantize_encoder_params of the shared
    fp32 weights) as numpy, with both configs set to quantize."""
    jconfig, tconfig, params, _ = shared_weights
    qparams = jbert.quantize_encoder_params(params)
    return (replace(jconfig, quantize=True), replace(tconfig, quantize=True),
            qparams, _numpy_tree(qparams))


def test_params_from_jax_takes_the_quantized_pytree(shared_weights,
                                                     quantized_weights):
    """The JAX package's int8 arrays, transposed to (out, in) (q, k and v
    concatenated into the packed qkv layer), equal the port's own
    quantization of the same fp32 weights; biases and scales too, and the
    scales stay fp32."""
    _, tconfig, _, params_np = shared_weights
    _, qtconfig, qparams, qparams_np = quantized_weights
    ported = tbert.params_from_jax(qparams_np, tconfig, device="cpu")
    ours = tbert.quantize_encoder(
        tbert.params_from_jax(params_np, tconfig, device="cpu"))
    built = tbert.params_from_jax(params_np, qtconfig, device="cpu")
    buffers = dict(ours.named_buffers())
    # qkv, attn_out, ffn_in, ffn_out: weight_q, weight_scale, bias each
    assert len(buffers) == 3 * 4 * tconfig.num_layers
    for encoder in (ported, built):
        assert encoder.config.quantize
        assert dict(encoder.named_buffers()).keys() == buffers.keys()
        for name, value in encoder.named_buffers():
            assert value.dtype == buffers[name].dtype, name
            assert torch.equal(value, buffers[name]), name
    H = tconfig.hidden_size
    assert buffers["layers.0.qkv.weight_q"].dtype == torch.int8
    assert tuple(buffers["layers.0.qkv.weight_q"].shape) == (3 * H, H)
    assert buffers["layers.0.qkv.weight_scale"].dtype == torch.float32
    assert not any(n.endswith(("query.weight", "key.weight", "value.weight"))
                   for n, _ in ours.named_parameters())
    # bit for bit the JAX package's q, k, v arrays, concatenated
    layers = jax.tree.map(np.asarray, qparams["layers"])
    for i in range(tconfig.num_layers):
        np.testing.assert_array_equal(
            buffers[f"layers.{i}.qkv.weight_q"].numpy(),
            np.concatenate([layers[w][i].T for w in
                            ("q_w_q", "k_w_q", "v_w_q")]))
        np.testing.assert_array_equal(
            buffers[f"layers.{i}.qkv.weight_scale"].numpy(),
            np.concatenate([layers[w][i][0] for w in
                            ("q_w_s", "k_w_s", "v_w_s")]))


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_quantized_encoder_fp32_matches_jax(quantized_weights, pooling):
    jconfig, tconfig, qparams, qparams_np = quantized_weights
    jconfig = replace(jconfig, pooling=pooling)
    tconfig = replace(tconfig, pooling=pooling)
    ids, mask, _ = _inputs(seed=8)
    ref = jbert.encode_tokens(qparams, jnp.asarray(ids), jnp.asarray(mask),
                              jconfig, compute_dtype=jnp.float32)
    encoder = tbert.params_from_jax(qparams_np, tconfig, device="cpu")
    out = tbert.encode_tokens(encoder, torch.from_numpy(ids),
                              torch.from_numpy(mask)).numpy()
    assert (_cosines(out, ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4)


def test_quantized_encoder_packed_fp32_matches_jax(quantized_weights):
    jconfig, tconfig, qparams, qparams_np = quantized_weights
    ids, mask, lengths = _inputs(B=9, seed=9)
    packed = _packed(ids, lengths, 32)
    arrays = (packed.input_ids, packed.segment_ids, packed.positions,
              packed.seq_index)
    ref = jbert.encode_tokens_packed(qparams, *map(jnp.asarray, arrays),
                                     packed.n_sequences, jconfig,
                                     compute_dtype=jnp.float32)
    encoder = tbert.params_from_jax(qparams_np, tconfig, device="cpu")
    out = tbert.encode_tokens_packed(encoder, *map(torch.from_numpy, arrays),
                                     packed.n_sequences).numpy()
    assert out.shape == (9, 64)
    assert (_cosines(out, ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4)


def test_quantized_encoder_stays_near_the_fp32_encoder(shared_weights):
    """As tests/test_quantization.py:38-54: cosine > 0.99 against the
    unquantized encoder on the same weights."""
    _, tconfig, _, params_np = shared_weights
    ids, mask, _ = _inputs(seed=10)
    outs = [tbert.encode_tokens(
        tbert.params_from_jax(params_np, replace(tconfig, quantize=q),
                              device="cpu"),
        torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        for q in (False, True)]
    assert (_cosines(outs[0], outs[1]) > 0.99).all()


def test_quantized_encoder_bf16_matches_jax(shared_weights):
    """Both packages the way their loaders run it: weights cast to bf16,
    then quantized; compute in bf16."""
    jconfig, tconfig, params, params_np = shared_weights
    ids, mask, _ = _inputs(seed=11)
    params16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    ref = jbert.encode_tokens(jbert.quantize_encoder_params(params16),
                              jnp.asarray(ids), jnp.asarray(mask),
                              replace(jconfig, quantize=True),
                              compute_dtype=jnp.bfloat16)
    encoder = tbert.params_from_jax(params_np,
                                    replace(tconfig, quantize=True),
                                    dtype=torch.bfloat16, device="cpu")
    assert encoder.layers[0].ffn_in.bias.dtype == torch.bfloat16
    assert encoder.layers[0].ffn_in.weight_scale.dtype == torch.float32
    out = tbert.encode_tokens(encoder, torch.from_numpy(ids),
                              torch.from_numpy(mask))
    assert (_cosines(out.numpy(), ref) > 1 - 1e-3).all()


def test_packed_qkv_is_the_concatenation_of_the_three_quantized_weights():
    """quantize_encoder's qkv layer holds quantize_weight of the float
    query, key and value weights (as held, in bf16) concatenated in that
    order, and their biases: bit for bit."""
    _, tconfig = _configs()
    float_encoder = tbert.init_encoder(tconfig,
                                       torch.Generator().manual_seed(3),
                                       dtype=torch.bfloat16, device="cpu")
    expected = []
    for layer in float_encoder.layers:
        parts = [tbert.quantize_weight(getattr(layer, n).weight)
                 for n in tbert.QKV]
        expected.append((torch.cat([q for q, _ in parts]),
                         torch.cat([s for _, s in parts]),
                         torch.cat([getattr(layer, n).bias
                                    for n in tbert.QKV])))
    encoder = tbert.quantize_encoder(float_encoder)
    for layer, (weight_q, weight_scale, bias) in zip(encoder.layers,
                                                     expected):
        assert not any(hasattr(layer, n) for n in tbert.QKV)
        assert torch.equal(layer.qkv.weight_q, weight_q)
        assert torch.equal(layer.qkv.weight_scale, weight_scale)
        assert torch.equal(layer.qkv.bias, bias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_qkv_output_equals_three_int8_layers(dtype):
    """One int8 GEMM over the (3H, H) packed weight gives q, k and v bit
    for bit as three int8_linear calls over the separate weights: the
    weights are quantized per output row, and a row of x has one scale for
    all three."""
    _, tconfig = _configs()
    float_layer = tbert.init_encoder(tconfig,
                                     torch.Generator().manual_seed(4),
                                     dtype=dtype, device="cpu").layers[0]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 16, tconfig.hidden_size)).astype(np.float32)).to(dtype)
    separate = [tbert.int8_linear(x, *tbert.quantize_weight(
        getattr(float_layer, n).weight), getattr(float_layer, n).bias)
        for n in tbert.QKV]
    packed = tbert.Int8Linear.from_weight(
        torch.cat([getattr(float_layer, n).weight for n in tbert.QKV]),
        torch.cat([getattr(float_layer, n).bias for n in tbert.QKV]))(x)
    assert torch.equal(packed, torch.cat(separate, dim=-1))


def test_quantized_block_runs_four_int8_linears(monkeypatch):
    """A quantized block calls int8_linear four times (qkv, attn_out,
    ffn_in, ffn_out), not six, padded and packed."""
    _, tconfig = _configs(quantize=True)
    encoder = tbert.init_encoder(tconfig, torch.Generator().manual_seed(5),
                                 device="cpu")
    calls = []

    def counting(x, w_q, w_scale, bias):
        calls.append(tuple(w_q.shape))
        return tbert.int8_linear_reference(x, w_q, w_scale, bias)

    monkeypatch.setattr(tbert, "int8_linear", counting)
    ids, mask, lengths = _inputs(seed=12)
    tbert.encode_tokens(encoder, torch.from_numpy(ids),
                        torch.from_numpy(mask))
    H, L = tconfig.hidden_size, tconfig.num_layers
    assert len(calls) == 4 * L
    assert calls[:4] == [(3 * H, H), (H, H), (tconfig.intermediate_size, H),
                         (H, tconfig.intermediate_size)]
    packed = _packed(ids, lengths, 32)
    tbert.encode_tokens_packed(encoder, *map(torch.from_numpy, (
        packed.input_ids, packed.segment_ids, packed.positions,
        packed.seq_index)), packed.n_sequences)
    assert len(calls) == 2 * 4 * L


def test_quantize_encoder_padded_and_packed_match_jax(shared_weights,
                                                      quantized_weights):
    """The port quantizing the fp32 weights itself (q, k, v packed) against
    the JAX package's quantized pytree and three int8 layers, padded and
    packed: cosine > 1 - 1e-5, atol 1e-4."""
    _, tconfig, _, params_np = shared_weights
    jconfig, qtconfig, qparams, _ = quantized_weights
    encoder = tbert.params_from_jax(params_np, qtconfig, device="cpu")
    assert isinstance(encoder.layers[0].qkv, tbert.Int8Linear)
    ids, mask, lengths = _inputs(B=9, seed=13)
    ref = jbert.encode_tokens(qparams, jnp.asarray(ids), jnp.asarray(mask),
                              jconfig, compute_dtype=jnp.float32)
    out = tbert.encode_tokens(encoder, torch.from_numpy(ids),
                              torch.from_numpy(mask)).numpy()
    assert (_cosines(out, ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4)
    packed = _packed(ids, lengths, 32)
    arrays = (packed.input_ids, packed.segment_ids, packed.positions,
              packed.seq_index)
    ref = jbert.encode_tokens_packed(qparams, *map(jnp.asarray, arrays),
                                     packed.n_sequences, jconfig,
                                     compute_dtype=jnp.float32)
    out = tbert.encode_tokens_packed(encoder, *map(torch.from_numpy, arrays),
                                     packed.n_sequences).numpy()
    assert (_cosines(out, ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4)


def test_init_encoder_quantizes_when_asked():
    _, tconfig = _configs(quantize=True)
    encoder = tbert.init_encoder(tconfig, torch.Generator().manual_seed(5),
                                 dtype=torch.bfloat16, device="cpu")
    layer = encoder.layers[0]
    assert all(isinstance(getattr(layer, name), tbert.Int8Linear)
               for name in tbert.QUANTIZED_LINEARS)
    float_encoder = tbert.init_encoder(
        replace(tconfig, quantize=False), torch.Generator().manual_seed(5),
        dtype=torch.bfloat16, device="cpu")
    q, s = tbert.quantize_weight(float_encoder.layers[0].ffn_out.weight)
    assert torch.equal(layer.ffn_out.weight_q, q)
    assert torch.equal(layer.ffn_out.weight_scale, s)


# --- the kernels read the projections' layout --------------------------------

def _lies_in(view, base) -> bool:
    """view's data lies inside base's storage (a view, not a copy)."""
    start = base.untyped_storage().data_ptr()
    end = start + base.untyped_storage().nbytes()
    return (view.untyped_storage().data_ptr() == start and
            start <= view.data_ptr() < end)


def _spy(seen, result):
    def attend(q, k, v, *mask):
        seen.append((q, k, v))
        return result(q, k, v, *mask)
    return attend


def _capture_outputs(modules):
    outputs = {}
    for name, module in modules.items():
        module.register_forward_hook(
            lambda _m, _i, out, name=name: outputs.__setitem__(name, out))
    return outputs


def test_encoder_layer_hands_projection_views_to_attention():
    """EncoderLayer (the BERT encoders, the cross-encoder, the HF-CLIP text
    towers) passes q, k and v as views of the projection outputs."""
    _, tconfig = _configs()
    layer = tbert.init_encoder(tconfig, torch.Generator().manual_seed(0),
                               device="cpu").layers[0]
    outputs = _capture_outputs({n: getattr(layer, n)
                                for n in ("query", "key", "value")})
    seen = []
    x = torch.randn(3, 16, tconfig.hidden_size)
    mask = torch.ones(3, 16, dtype=torch.int32)
    layer(x, _spy(seen, tbert._ATTENTION[("kernel", "padding")]), mask)
    (q, k, v), = seen
    for t, name in ((q, "query"), (k, "key"), (v, "value")):
        assert t.shape == (3, tconfig.num_heads, 16, tconfig.head_dim)
        assert t.stride(-1) == 1 and not t.is_contiguous()
        assert _lies_in(t, outputs[name]), name


def test_quantized_layer_hands_views_of_the_packed_qkv_to_attention():
    """The quantized EncoderLayer passes q, k and v as (B, N, S, D) views
    of the one qkv output: token stride 3H, offsets 0, H, 2H."""
    _, tconfig = _configs(quantize=True)
    layer = tbert.init_encoder(tconfig, torch.Generator().manual_seed(0),
                               device="cpu").layers[0]
    outputs = _capture_outputs({"qkv": layer.qkv})
    seen = []
    x = torch.randn(3, 16, tconfig.hidden_size)
    mask = torch.ones(3, 16, dtype=torch.int32)
    layer(x, _spy(seen, tbert._ATTENTION[("kernel", "padding")]), mask)
    (q, k, v), = seen
    H, N, D = tconfig.hidden_size, tconfig.num_heads, tconfig.head_dim
    base = outputs["qkv"]
    for i, t in enumerate((q, k, v)):
        assert t.shape == (3, N, 16, D)
        assert t.stride() == (16 * 3 * H, D, 3 * H, 1)
        assert _lies_in(t, base)
        assert t.data_ptr() - base.data_ptr() == i * H * t.element_size()


def test_prenorm_block_hands_projection_views_to_attention():
    from marqo_tpu_torch.models import clip as tclip
    block = tclip.PreNormBlock(64, 128, 4, "quick_gelu", 1e-5)
    outputs = _capture_outputs({n: getattr(block, n) for n in "qkv"})
    seen = []
    block(torch.randn(2, 50, 64),
          _spy(seen, tclip.fused_attention.fused_attention))
    (q, k, v), = seen
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        assert t.shape == (2, 4, 50, 16)
        assert t.stride(-1) == 1 and not t.is_contiguous()
        assert _lies_in(t, outputs[name]), name


def test_stella_layer_hands_v_as_a_view_of_the_fused_projection(
        monkeypatch):
    """RoPE writes new q and k; v is a chunk of the fused qkv output."""
    from marqo_tpu_torch.models import stella as tstella
    config = tstella.StellaConfig(vocab_size=64, hidden_size=64,
                                  num_layers=1, num_heads=4,
                                  intermediate_size=128, projection_dim=32)
    layer = tstella.init_stella(config, torch.Generator().manual_seed(0),
                                device="cpu").layers[0]
    outputs = _capture_outputs({"qkv": layer.qkv})
    seen = []
    monkeypatch.setattr(tstella.flash_attention, "attention_padding",
                        _spy(seen, tstella.flash_attention.attention_padding))
    S = 12
    rope = tstella.rope_tables(S, config.head_dim, config.rope_theta, "cpu")
    layer(torch.randn(2, S, 64), torch.ones(2, S, dtype=torch.int32), rope)
    (q, k, v), = seen
    assert v.stride(-1) == 1 and _lies_in(v, outputs["qkv"])
    assert all(t.stride(-1) == 1 for t in (q, k))
