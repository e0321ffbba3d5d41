"""marqo_tpu_torch/parallel (the mesh, the sharded encode, the contrastive
train step) against marqo_tpu/parallel on the JAX tests' 8 virtual CPU
devices (tests/conftest.py), the port's mesh over the CPU repeated 8 times.

The same weights go to both packages (marqo_tpu's pytree through
``params_from_jax``), at the JAX multi-chip test's tiny config. Tolerances
are the JAX test's own (sharded encode atol 1e-5 in fp32), InfoNCE within
1e-6, the train step's first gradients within 1e-4 of each leaf's largest
magnitude, and five steps' losses within 1e-3 relative plus the fp32
resolution of the logits they come from.
"""

import inspect
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from marqo_tpu.models.bert import TextEncoderConfig as JaxConfig
from marqo_tpu.models.bert import encode_tokens as jax_encode_tokens
from marqo_tpu.models.bert import init_params
from marqo_tpu.parallel import encode as jencode
from marqo_tpu.parallel import mesh as jmesh
from marqo_tpu.parallel import train_step as jtrain
from marqo_tpu_torch.models import bert as tbert
from marqo_tpu_torch.ops.packing import pack_sequences
from marqo_tpu_torch.parallel import encode as tencode
from marqo_tpu_torch.parallel import mesh as tmesh
from marqo_tpu_torch.parallel import train_step as ttrain

SMALL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position_embeddings=64)
CPU8 = [torch.device("cpu")] * 8
TEMPERATURE = 0.05


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's fp32 encoder on the CPU) on one seed."""
    params = init_params(JaxConfig(**SMALL), jax.random.PRNGKey(0))
    numpy = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    encoder = tbert.params_from_jax(numpy, tbert.TextEncoderConfig(**SMALL),
                                    device="cpu")
    return params, encoder


def _batch(n=16, seq=12, seed=0):
    """Ragged (n, seq) ids and padding mask."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, seq + 1, n)
    lengths[0] = seq
    mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.int32)
    ids = (rng.integers(1, 256, (n, seq)) * mask).astype(np.int32)
    return ids, mask


def _train_batch(seed=0):
    """The JAX test's batch: 8 query/passage pairs of 12 tokens."""
    rng = np.random.default_rng(seed)
    return {
        "query_ids": rng.integers(1, 256, (8, 12)).astype(np.int32),
        "query_mask": np.ones((8, 12), np.int32),
        "passage_ids": rng.integers(1, 256, (8, 12)).astype(np.int32),
        "passage_mask": np.ones((8, 12), np.int32),
    }


# --- the mesh ---------------------------------------------------------------

def test_create_mesh_shapes(monkeypatch):
    mesh = tmesh.create_mesh(CPU8, shape=(4, 2))
    assert mesh.shape == {tmesh.AXIS_DP: 4, tmesh.AXIS_TP: 2}
    assert mesh.shape == dict(jmesh.create_mesh(jax.devices()[:8],
                                                shape=(4, 2)).shape)
    assert len(mesh.groups()) == 4 and all(len(g) == 2
                                           for g in mesh.groups())
    with pytest.raises(ValueError):
        tmesh.create_mesh(CPU8, shape=(3, 2))
    assert tmesh.create_mesh(CPU8).shape == {"dp": 8, "tp": 1}
    monkeypatch.setenv("MARQO_TPU_MESH_SHAPE", "2,4")
    assert tmesh.create_mesh(CPU8).shape == {"dp": 2, "tp": 4}


def test_virtual_mesh_over_a_repeated_device():
    """One card named four times: a (2, 2) mesh whose groups hold the same
    device, each group led by it (no card is touched here)."""
    card = torch.device("cuda", 0)
    mesh = tmesh.create_mesh([card] * 4, shape=(2, 2))
    assert mesh.groups() == [(card, card), (card, card)]
    assert mesh.lead == card and set(mesh.devices.flat) == {card}


def _jax_dim(spec, weight: bool):
    """The per-layer dim that a stacked JAX leaf's PartitionSpec splits
    over tp, in nn.Linear's (out, in) layout: the JAX package stores
    (in, out), so a weight's axis flips."""
    axes = list(spec)[1:]
    if jmesh.AXIS_TP not in axes:
        return None
    axis = axes.index(jmesh.AXIS_TP)
    return 1 - axis if weight else axis


def test_param_specs_cover_every_parameter_and_match_jax(weights):
    params, encoder = weights
    specs = tmesh.encoder_param_specs(encoder)
    assert set(specs) == {n for n, _ in encoder.named_parameters()}
    jax_specs = jmesh.encoder_param_specs(params)
    assert all(s == jax.sharding.PartitionSpec()
               for s in jax_specs["embeddings"].values())
    for name, dim in specs.items():
        if name.startswith("embeddings."):
            assert dim is None, name
            continue
        _, _, layer, kind = name.split(".")
        w_key, b_key = tbert._JAX_LAYER[layer]
        key = w_key if kind == "weight" else b_key
        weight = kind == "weight" and np.ndim(params["layers"][key]) == 3
        assert dim == _jax_dim(jax_specs["layers"][key], weight), name


def test_specs_refuse_the_int8_layout(weights):
    _, encoder = weights
    quantized = tbert.quantize_encoder(
        tbert.params_from_jax(jax.tree.map(np.asarray, weights[0]),
                              tbert.TextEncoderConfig(**SMALL),
                              device="cpu"))
    with pytest.raises(KeyError):
        tmesh.encoder_param_specs(quantized)
    with pytest.raises(ValueError):
        tencode.ShardedTextEncoder(quantized.config, CPU8[:2])


@pytest.mark.parametrize("heads, ffn, tp", [(4, 128, 3), (4, 126, 4)],
                         ids=["heads", "ffn"])
def test_tp_that_does_not_divide_raises(heads, ffn, tp):
    config = tbert.TextEncoderConfig(**{**SMALL, "num_heads": heads,
                                        "intermediate_size": ffn})
    encoder = tbert.init_encoder(config, torch.Generator().manual_seed(0),
                                 device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        tencode.ShardedTextEncoder.from_encoder(encoder, CPU8[:tp])
    mesh = tmesh.create_mesh(CPU8[:2 * tp], shape=(2, tp))
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_params(encoder, mesh)
    with pytest.raises(ValueError, match="does not divide"):
        tencode.make_sharded_encode(mesh, config, torch.float32)


# --- the sharded encode -----------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (2, 4)],
                         ids=["4x2", "8x1", "2x4"])
def test_sharded_encode_matches_jax(weights, shape):
    params, encoder = weights
    ids, mask = _batch(seed=sum(shape))
    jax_mesh = jmesh.create_mesh(jax.devices()[:8], shape=shape)
    expected = np.asarray(jencode.make_sharded_encode(
        jax_mesh, JaxConfig(**SMALL), compute_dtype=jnp.float32)(
        jmesh.shard_params(params, jax_mesh), jnp.asarray(ids),
        jnp.asarray(mask)))

    mesh = tmesh.create_mesh(CPU8, shape=shape)
    sharded = tmesh.shard_params(encoder, mesh)
    assert len(sharded) == shape[0]
    shard = sharded[0].shards[0].layers[0]
    H, tp = SMALL["hidden_size"], shape[1]
    assert tuple(shard.query.weight.shape) == (H // tp, H)
    assert tuple(shard.attn_out.weight.shape) == (H, H // tp)
    assert tuple(shard.ffn_in.weight.shape) == (SMALL["intermediate_size"]
                                                // tp, H)
    out = tencode.make_sharded_encode(mesh, encoder.config, torch.float32)(
        sharded, ids, mask)
    np.testing.assert_allclose(out.numpy(), expected, atol=1e-5)
    single = tbert.encode_tokens(encoder, torch.from_numpy(ids),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), single.numpy(), atol=1e-5)


@pytest.mark.parametrize("second", [torch.device("cpu"),
                                    torch.device("cpu", 0)],
                         ids=["virtual", "distinct"])
def test_shards_share_storage_only_on_a_virtual_mesh(weights, second):
    """Over one device repeated, the lead shard's split weights are views
    of the encoder's; over distinct devices (here the CPU named a second
    way) the lead shard owns its part, so the unsharded weight can go.
    The encode is the same either way."""
    _, encoder = weights
    sharded = tencode.ShardedTextEncoder.from_encoder(
        encoder, [torch.device("cpu"), second])
    full = encoder.layers[0].query.weight
    lead = sharded.shards[0].layers[0].query.weight
    assert torch.equal(lead, full[:SMALL["hidden_size"] // 2])
    shares = lead.untyped_storage().data_ptr() == \
        full.untyped_storage().data_ptr()
    assert shares == (second == torch.device("cpu"))
    assert sharded.embeddings.word.weight.data_ptr() == \
        encoder.embeddings.word.weight.data_ptr()
    ids, mask = _batch(n=4, seed=3)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    torch.testing.assert_close(
        tbert.encode_tokens(sharded, ids, mask),
        tbert.encode_tokens(encoder, ids, mask), atol=1e-5, rtol=0)


def test_sharded_encode_refuses_a_batch_dp_does_not_divide(weights):
    _, encoder = weights
    mesh = tmesh.create_mesh(CPU8, shape=(4, 2))
    ids, mask = _batch(n=6)
    with pytest.raises(ValueError, match="does not split"):
        tencode.make_sharded_encode(mesh, encoder.config, torch.float32)(
            tmesh.shard_params(encoder, mesh), ids, mask)
    with pytest.raises(ValueError, match="held in"):
        tencode.make_sharded_encode(mesh, encoder.config, torch.bfloat16)(
            tmesh.shard_params(encoder, mesh), *_batch(n=8))


# --- the packed path under dp -----------------------------------------------

def _packed(seed=0, n=24, seq=32):
    """Ragged sequences packed first-fit-decreasing into 8 rows, which
    interleaves the sequences' order across rows."""
    rng = np.random.default_rng(seed)
    sequences = [rng.integers(5, 256, int(L)).astype(np.int32)
                 for L in rng.integers(2, seq, n)]
    return pack_sequences(sequences, seq_len=seq, row_buckets=[8])


def _rows(packed):
    return (packed.input_ids, packed.segment_ids, packed.positions,
            packed.seq_index)


def test_packed_encode_under_dp_matches_unsharded(weights):
    """Each dp group's rows give pooling sums over the whole batch's
    sequence index; their sum is the unsharded packed encode. Pooling each
    group's rows on their own, by a local index, is wrong."""
    _, encoder = weights
    packed = _packed()
    n = packed.n_sequences
    expected = tbert.encode_tokens_packed(
        encoder, *(torch.from_numpy(a) for a in _rows(packed)), n)

    mesh = tmesh.create_mesh(CPU8[:4], shape=(2, 2))
    replicas = tmesh.shard_params(encoder, mesh)
    parts = [tbert.packed_segment_sums(replica, *rows, n) for replica, rows
             in zip(replicas, tmesh.split_batch(mesh, *_rows(packed)))]
    sums = sum(p[0] for p in parts)
    counts = sum(p[1] for p in parts)
    out = tbert.pool_segment_sums(sums, counts, encoder.config)
    np.testing.assert_allclose(out.numpy(), expected.numpy(), atol=2e-5)

    # the wrong variant: each group pools its own rows by a local index,
    # and the groups' rows are concatenated in group order
    local = []
    for replica, (ids, seg, pos, idx) in zip(
            replicas, tmesh.split_batch(mesh, *_rows(packed))):
        owners = torch.unique(idx[idx >= 0])
        remap = {int(o): i for i, o in enumerate(owners)}
        local_idx = idx.clone().apply_(lambda v: remap.get(v, -1))
        local.append(tbert.encode_tokens_packed(
            replica, ids, seg, pos, local_idx, len(owners)))
    wrong = torch.cat(local)
    assert wrong.shape == expected.shape
    assert (wrong - expected).abs().max() > 1e-2


# --- the train step ---------------------------------------------------------

def test_info_nce_loss_matches_jax():
    rng = np.random.default_rng(0)
    q, p = (rng.standard_normal((8, 16)).astype(np.float32) for _ in "qp")
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    expected = float(jtrain.info_nce_loss(jnp.asarray(q), jnp.asarray(p)))
    got = float(ttrain.info_nce_loss(torch.from_numpy(q),
                                     torch.from_numpy(p)))
    assert abs(got - expected) <= 1e-6 * max(1.0, abs(expected))
    identity = torch.eye(4, 8)
    assert float(ttrain.info_nce_loss(identity, identity)) < 0.01


def test_adamw_hyperparameters_are_optax_defaults(weights):
    _, encoder = weights
    defaults = inspect.signature(optax.adamw).parameters
    mesh = tmesh.create_mesh(CPU8, shape=(4, 2))
    _, optimizer = ttrain.make_train_state(encoder, mesh, 5e-3)
    group = optimizer.param_groups[0]
    assert group["betas"] == (defaults["b1"].default, defaults["b2"].default)
    assert group["eps"] == defaults["eps"].default
    assert group["weight_decay"] == defaults["weight_decay"].default
    assert group["lr"] == 5e-3


def test_training_refuses_the_int8_encoder(weights):
    _, encoder = weights
    mesh = tmesh.create_mesh(CPU8, shape=(4, 2))
    config = replace(encoder.config, quantize=True)
    _, optimizer = ttrain.make_train_state(encoder, mesh)
    with pytest.raises(ValueError, match="int8"):
        ttrain.make_train_step(config, mesh, optimizer)
    quantized = tbert.quantize_encoder(
        tbert.params_from_jax(jax.tree.map(np.asarray, weights[0]),
                              tbert.TextEncoderConfig(**SMALL),
                              device="cpu"))
    with pytest.raises(ValueError, match="int8"):
        ttrain.make_train_state(quantized, mesh)


def _jax_loss_fn(config):
    def loss_fn(params, batch):
        q = jax_encode_tokens(params, batch["query_ids"],
                              batch["query_mask"], config,
                              compute_dtype=jnp.float32)
        p = jax_encode_tokens(params, batch["passage_ids"],
                              batch["passage_mask"], config,
                              compute_dtype=jnp.float32)
        return jtrain.info_nce_loss(q, p, TEMPERATURE)
    return loss_fn


def _jax_leaf(tree, name: str):
    """The JAX gradient leaf of the port's parameter ``name``, in the
    port's (out, in) layout."""
    if name.startswith("embeddings."):
        key = {"word.weight": "word", "position.weight": "position",
               "token_type.weight": "token_type", "ln.weight": "ln_scale",
               "ln.bias": "ln_bias"}[name.split(".", 1)[1]]
        return np.asarray(tree["embeddings"][key])
    _, i, layer, kind = name.split(".")
    w_key, b_key = tbert._JAX_LAYER[layer]
    leaf = np.asarray(tree["layers"][w_key if kind == "weight" else b_key])
    leaf = leaf[int(i)]
    return leaf.T if leaf.ndim == 2 else leaf


def test_train_step_gradients_match_jax_grad(weights):
    params, encoder = weights
    batch = _train_batch()
    loss, grads = jax.value_and_grad(_jax_loss_fn(JaxConfig(**SMALL)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})

    mesh = tmesh.create_mesh(CPU8, shape=(4, 2))
    master, optimizer = ttrain.make_train_state(encoder, mesh, 5e-3)
    step = ttrain.make_train_step(encoder.config, mesh, optimizer,
                                  compute_dtype=torch.float32)
    got_loss = float(step(master, batch))
    assert abs(got_loss - float(loss)) <= 1e-5 * abs(float(loss))
    largest = max(float(np.abs(g).max()) for g in jax.tree.leaves(grads))
    for name, param in master.named_parameters():
        expected = _jax_leaf(grads, name)
        assert param.grad is not None, name
        if name.endswith("key.bias"):
            # analytically zero (the softmax over keys ignores q·b_k, the
            # same for every key): both sides are rounding noise
            assert np.abs(expected).max() <= 1e-6 * largest, name
            assert param.grad.abs().max() <= 1e-6 * largest, name
            continue
        np.testing.assert_allclose(param.grad.numpy(), expected,
                                   atol=1e-4 * np.abs(expected).max(),
                                   rtol=0, err_msg=name)


def test_five_steps_match_jax_and_decrease(weights):
    params, encoder = weights
    batch = _train_batch()
    jax_mesh = jmesh.create_mesh(jax.devices()[:8], shape=(4, 2))
    p, optimizer, opt_state = jtrain.make_train_state(params, jax_mesh,
                                                      learning_rate=5e-3)
    jax_step = jtrain.make_train_step(JaxConfig(**SMALL), jax_mesh,
                                      optimizer, compute_dtype=jnp.float32)
    expected = []
    for _ in range(5):
        p, opt_state, loss = jax_step(p, opt_state, batch)
        expected.append(float(loss))

    mesh = tmesh.create_mesh(CPU8, shape=(4, 2))
    master, optimizer = ttrain.make_train_state(encoder, mesh, 5e-3)
    step = ttrain.make_train_step(encoder.config, mesh, optimizer,
                                  compute_dtype=torch.float32)
    got = [float(step(master, batch)) for _ in range(5)]
    # the loss is log-softmax over logits of magnitude up to 1/temperature:
    # below that, fp32 resolves it to about 4 ulps of 1/temperature
    floor = 4 * np.finfo(np.float32).eps / TEMPERATURE
    for a, b in zip(got, expected):
        assert abs(a - b) <= 1e-3 * abs(b) + floor, (got, expected)
    assert got[-1] < got[0] and expected[-1] < expected[0]


def test_step_on_a_mesh_equals_the_one_device_step(weights):
    """Step 1's loss on a (2, 2) mesh equals the (1, 1) mesh's in fp32:
    the tp reductions and the dp gather change nothing but rounding."""
    _, encoder = weights
    batch = _train_batch(seed=3)
    losses = []
    for shape in ((2, 2), (1, 1)):
        mesh = tmesh.create_mesh(CPU8[:shape[0] * shape[1]], shape=shape)
        master, optimizer = ttrain.make_train_state(encoder, mesh, 1e-3)
        step = ttrain.make_train_step(encoder.config, mesh, optimizer,
                                      compute_dtype=torch.float32)
        losses.append(float(step(master, batch)))
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
