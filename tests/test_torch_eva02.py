"""marqo_tpu_torch's EVA02-CLIP (models/eva02.py) against marqo_tpu's.

The same weights go to both packages: marqo_tpu's pytree through
``params_from_jax`` (every array perturbed, so a dropped bias or a
misplaced LayerNorm shows), or one timm/open_clip-format state dict through
each package's converter and wrapper. Inputs are made with numpy from a
seed. Tolerances are the reference's own: one block in fp32 within atol
2e-5 (tests/test_eva02_parity.py), the towers in fp32 at cosine > 1 - 1e-5
(and atol 1e-4), in bf16 at cosine > 1 - 1e-3. On the CPU the blocks'
attention is kernel B2's plain twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.inference.types import Device as JaxDevice
from marqo_tpu.inference.types import Modality as JaxModality
from marqo_tpu.models import eva02 as jeva
from marqo_tpu.models.clip import CLIPTextConfig as JaxCLIPTextConfig
from marqo_tpu_torch.core.exceptions import ModelLoadError, VectoriseError
from marqo_tpu_torch.inference.loaders import load_model, resolve_model_class
from marqo_tpu_torch.inference.types import Device, Modality
from marqo_tpu_torch.models import eva02 as teva
from marqo_tpu_torch.models.bert import empty_module, fill_parameters
from marqo_tpu_torch.models.clip import CLIPTextConfig
from marqo_tpu_torch.ops.fused_attention import fused_attention
from tests.test_eva02_parity import torch_eva_block

TEXT = dict(vocab_size=60, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, projection_dim=24, hidden_act="gelu",
            eos_token_id=59)
# 32 px at patch 8: a 4 x 4 grid (17 tokens), head dim 16
VISION = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=2,
              num_heads=2, swiglu_hidden=48, embed_dim=24)


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32) + 0.02 *
                                   rng.standard_normal(np.shape(a))
                                   ).astype(np.float32), tree)


def _cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) *
                              np.linalg.norm(b, axis=-1))


@pytest.fixture(scope="module")
def shared():
    """The JAX package's perturbed params (the RoPE table left exact) and
    the port's model built from the same numpy arrays, fp32 on the CPU."""
    jtext, jvision = JaxCLIPTextConfig(**TEXT), jeva.EVA02VisionConfig(
        **VISION)
    params = jeva.init_eva02_params(jtext, jvision, jax.random.PRNGKey(0))
    table = np.asarray(params["vision"]["rope_table"])
    params = _perturbed(params, 1)
    params["vision"]["rope_table"] = table
    model = teva.params_from_jax(params, CLIPTextConfig(**TEXT),
                                 teva.EVA02VisionConfig(**VISION),
                                 device="cpu")
    return jax.tree.map(jnp.asarray, params), model, jtext, jvision


def _pixels(seed=4, B=3, size=32):
    return np.random.default_rng(seed).integers(
        0, 256, (B, size, size, 3)).astype(np.uint8)


# --- RoPE and one block ------------------------------------------------------

@pytest.mark.parametrize("grid, head_dim", [(4, 16), (24, 64), (16, 64)])
def test_rope_table_equals_jax(grid, head_dim):
    out = teva.rope_2d_freqs(grid, head_dim)
    assert out.shape == (grid * grid, 2 * head_dim)
    np.testing.assert_array_equal(out, jeva.rope_2d_freqs(grid, head_dim))


def test_apply_rope_matches_jax():
    D, grid = 16, 4
    table = teva.rope_2d_freqs(grid, D)
    sin, cos = table[:, :D], table[:, D:]
    x = np.random.default_rng(1).standard_normal(
        (2, 3, grid * grid, D)).astype(np.float32)
    ref = np.asarray(jeva._apply_rope(jnp.asarray(x), jnp.asarray(sin),
                                      jnp.asarray(cos)))
    out = teva._apply_rope(torch.from_numpy(x), torch.from_numpy(sin),
                           torch.from_numpy(cos)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    np.testing.assert_array_equal(
        teva._rot(torch.arange(6.0)).numpy(), [-1, 0, -3, 2, -5, 4])


def _block_params(H=32, I=48, seed=0):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.1

    return {"q_w": mk(H, H), "q_b": mk(H), "k_w": mk(H, H),
            "v_w": mk(H, H), "v_b": mk(H), "o_w": mk(H, H), "o_b": mk(H),
            "ln1_scale": 1 + mk(H), "ln1_bias": mk(H),
            "ln2_scale": 1 + mk(H), "ln2_bias": mk(H),
            "w1_gate": mk(H, I), "b1_gate": mk(I),
            "w1_val": mk(H, I), "b1_val": mk(I),
            "ffn_ln_scale": 1 + mk(I), "ffn_ln_bias": mk(I),
            "w2": mk(I, H), "b2": mk(H)}


def _torch_block(lp, H=32, heads=4, I=48):
    config = teva.EVA02VisionConfig(hidden_size=H, num_heads=heads,
                                    swiglu_hidden=I)
    block = empty_module(lambda: teva.EVA02Block(config), torch.float32,
                         "cpu")
    values = {}
    for name, (w, b) in teva._EVA_BLOCK.items():
        values[f"{name}.weight"] = lp[w].T
        if b is not None:
            values[f"{name}.bias"] = lp[b]
    return fill_parameters(block, values)


def test_block_matches_jax_and_the_torch_mirror():
    H, heads, I, grid = 32, 4, 48, 3
    D = H // heads
    lp = _block_params(H, I)
    x = np.random.default_rng(2).normal(
        size=(2, grid * grid + 1, H)).astype(np.float32) * 0.1
    table = teva.rope_2d_freqs(grid, D)
    sin, cos = table[:, :D], table[:, D:]
    ref = np.asarray(jeva._eva_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in lp.items()},
        jnp.asarray(sin), jnp.asarray(cos), heads, 1e-6))
    block = _torch_block(lp, H, heads, I)
    out = block(torch.from_numpy(x), torch.from_numpy(sin),
                torch.from_numpy(cos), fused_attention).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)
    mirror = torch_eva_block(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in lp.items()},
        torch.from_numpy(sin), torch.from_numpy(cos), heads, 1e-6).numpy()
    np.testing.assert_allclose(out, mirror, atol=2e-5)
    assert block.k.bias is None


def test_class_token_is_not_rotated():
    """A block whose attention returns v sees q and k only through the
    kernel's inputs: the class row of q and k enters unrotated."""
    H, heads, I = 32, 4, 48
    D = H // heads
    block = _torch_block(_block_params(H, I, seed=3), H, heads, I)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 10, H)).astype(np.float32))
    table = torch.from_numpy(teva.rope_2d_freqs(3, D))
    seen = {}

    def attend(q, k, v):
        seen["q"], seen["k"] = q, k
        return v

    block(x, table[:, :D], table[:, D:], attend)
    h = torch.nn.functional.layer_norm(x, (H,), block.ln1.weight,
                                       block.ln1.bias, 1e-6)
    q = block.q(h).view(1, 10, heads, D).transpose(1, 2)
    assert torch.allclose(seen["q"][:, :, 0], q[:, :, 0])
    assert not torch.allclose(seen["q"][:, :, 1:], q[:, :, 1:])
    assert seen["q"].stride(-1) == 1 and seen["k"].stride(-1) == 1


# --- the towers --------------------------------------------------------------

def test_vision_tower_matches_jax(shared):
    params, model, _, jvision = shared
    pixels = _pixels()
    ref = np.asarray(jeva.encode_eva02_image(
        params, jnp.asarray(pixels), jvision, compute_dtype=jnp.float32))
    out = teva.encode_eva02_image(model, torch.from_numpy(pixels))
    assert out.dtype == torch.float32 and tuple(out.shape) == (3, 24)
    assert (_cosines(out.numpy(), ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_text_tower_matches_jax(shared):
    params, model, jtext, _ = shared
    rng = np.random.default_rng(5)
    ids = rng.integers(1, 59, (4, 77)).astype(np.int32)
    ids[np.arange(4), [3, 10, 40, 76]] = 59
    ref = np.asarray(jeva.encode_eva02_text_jit(
        params, jnp.asarray(ids), jtext, compute_dtype=jnp.float32))
    out = teva.encode_eva02_text(model, torch.from_numpy(ids)).numpy()
    assert (_cosines(out, ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_bf16_towers_track_jax(shared):
    params, _, jtext, jvision = shared
    model = teva.params_from_jax(jax.tree.map(np.asarray, params),
                                 CLIPTextConfig(**TEXT),
                                 teva.EVA02VisionConfig(**VISION),
                                 dtype=torch.bfloat16, device="cpu")
    params16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    pixels = _pixels(seed=6)
    ref = jeva.encode_eva02_image(params16, jnp.asarray(pixels), jvision)
    out = teva.encode_eva02_image(model, torch.from_numpy(pixels))
    assert out.dtype == torch.float32
    assert (_cosines(out.numpy(), np.asarray(ref, np.float32))
            > 1 - 1e-3).all()
    assert model.vision.rope_table.dtype == torch.bfloat16


def test_random_init_fills_the_rope_table():
    config = teva.EVA02VisionConfig(**VISION)
    model = teva.init_eva02_params(
        CLIPTextConfig(**TEXT), config,
        torch.Generator().manual_seed(0), device="cpu")
    np.testing.assert_array_equal(model.vision.rope_table.numpy(),
                                  jeva.rope_2d_freqs(4, 16))
    assert float(model.vision.layers[0].q.bias.abs().sum()) == 0.0


@pytest.mark.parametrize("token", list(jeva.EVA02_ARCHS))
def test_published_config_shapes(token):
    """The published EVA02-CLIP widths, on the meta device (no storage)."""
    (w, L, h, patch, swiglu, embed), (tw, tL, th, tmlp) = \
        teva.EVA02_ARCHS[token]
    image = 336 if "336" in token else 224
    vision = teva.EVA02VisionConfig(image_size=image, patch_size=patch,
                                    hidden_size=w, num_layers=L,
                                    num_heads=h, swiglu_hidden=swiglu,
                                    embed_dim=embed)
    tower = empty_module(lambda: teva.EVA02VisionTower(vision),
                         torch.float32, "meta")
    n = (image // patch) ** 2
    assert tuple(tower.position_embedding.shape) == (n + 1, w)
    assert tuple(tower.layers[0].w1_gate.weight.shape) == (swiglu, w)
    assert tower.layers[0].k.bias is None and len(tower.layers) == L
    assert tuple(tower.head_w.shape) == (w, embed)
    assert tuple(tower.rope_table.shape) == (n, 2 * (w // h))


# --- the converter and the wrapper ------------------------------------------

def _state_dict(text_prefix="text.", seed=7, vocab=60):
    """A timm-trunk + open_clip-text EVA02 state dict at the tiny widths,
    in the key layout the converters read (torch tensors)."""
    rng = np.random.default_rng(seed)
    H, I, p = VISION["hidden_size"], VISION["swiglu_hidden"], 8
    tH, tI = TEXT["hidden_size"], TEXT["intermediate_size"]

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                * 0.1)

    V = "visual.trunk."
    sd = {V + "patch_embed.proj.weight": t(H, 3, p, p),
          V + "patch_embed.proj.bias": t(H), V + "cls_token": t(1, 1, H),
          V + "pos_embed": t(1, 17, H), V + "norm.weight": 1 + t(H),
          V + "norm.bias": t(H), V + "head.weight": t(24, H)}
    for i in range(VISION["num_layers"]):
        b = f"{V}blocks.{i}."
        sd.update({b + "attn.q_proj.weight": t(H, H),
                   b + "attn.k_proj.weight": t(H, H),
                   b + "attn.v_proj.weight": t(H, H),
                   b + "attn.proj.weight": t(H, H),
                   b + "attn.proj.bias": t(H),
                   b + "norm1.weight": 1 + t(H), b + "norm1.bias": t(H),
                   b + "norm2.weight": 1 + t(H), b + "norm2.bias": t(H),
                   b + "mlp.fc1_g.weight": t(I, H), b + "mlp.fc1_g.bias": t(I),
                   b + "mlp.fc1_x.weight": t(I, H), b + "mlp.fc1_x.bias": t(I),
                   b + "mlp.norm.weight": 1 + t(I), b + "mlp.norm.bias": t(I),
                   b + "mlp.fc2.weight": t(H, I), b + "mlp.fc2.bias": t(H)})
        if i == 0:  # the q and v biases are optional (zero when absent)
            sd[b + "attn.q_bias"] = t(H)
            sd[b + "attn.v_bias"] = t(H)
    tp = text_prefix
    sd.update({tp + "token_embedding.weight": t(vocab, tH),
               tp + "positional_embedding": t(77, tH),
               tp + "ln_final.weight": 1 + t(tH), tp + "ln_final.bias": t(tH),
               tp + "text_projection": t(tH, 24)})
    for i in range(TEXT["num_layers"]):
        b = f"{tp}transformer.resblocks.{i}."
        sd.update({b + "attn.in_proj_weight": t(3 * tH, tH),
                   b + "attn.in_proj_bias": t(3 * tH),
                   b + "attn.out_proj.weight": t(tH, tH),
                   b + "attn.out_proj.bias": t(tH),
                   b + "ln_1.weight": 1 + t(tH), b + "ln_1.bias": t(tH),
                   b + "ln_2.weight": 1 + t(tH), b + "ln_2.bias": t(tH),
                   b + "mlp.c_fc.weight": t(tI, tH), b + "mlp.c_fc.bias": t(tI),
                   b + "mlp.c_proj.weight": t(tH, tI),
                   b + "mlp.c_proj.bias": t(tH)})
    return sd


@pytest.mark.parametrize("text_prefix", ["text.", ""])
def test_converter_matches_jax(text_prefix):
    sd = _state_dict(text_prefix)
    ref = jeva.params_from_open_clip_eva02(
        sd, JaxCLIPTextConfig(**TEXT), jeva.EVA02VisionConfig(**VISION),
        dtype=jnp.float32)
    out = teva.params_from_open_clip_eva02(
        sd, CLIPTextConfig(**TEXT), teva.EVA02VisionConfig(**VISION))
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    out_leaves = dict(jax.tree_util.tree_leaves_with_path(out))
    assert len(ref_leaves) == len(out_leaves)
    for path, value in ref_leaves:
        assert out_leaves[path].dtype == np.float32
        np.testing.assert_array_equal(out_leaves[path], np.asarray(value),
                                      err_msg=str(path))


def _tiny_arch(monkeypatch):
    """Both packages' "EVA02-B-16" token at the state dict's widths."""
    arch = ((32, 2, 2, 8, 48, 24), (32, 2, 2, 64))
    monkeypatch.setitem(jeva.EVA02_ARCHS, "EVA02-B-16", arch)
    monkeypatch.setitem(teva.EVA02_ARCHS, "EVA02-B-16", arch)


@pytest.fixture
def both_wrappers(tmp_path, monkeypatch):
    """One checkpoint file (the CLIP vocabulary the name's text config
    expects) loaded, with the gate open, by both packages' wrappers in
    fp32, each with the test wordpiece tokenizer."""
    path = str(tmp_path / "open_clip_pytorch_model.bin")
    torch.save(_state_dict(vocab=49408), path)
    _tiny_arch(monkeypatch)
    monkeypatch.setenv("MARQO_ALLOW_UNVERIFIED_CONVERSION", "TRUE")
    name = "open_clip/EVA02-B-16/merged2b_s8b_b131k"
    props = {"name": name, "localpath": path, "image_size": 32,
             "dimensions": 24}
    jmodel = jeva.JaxEVA02Model(name, props, JaxDevice.CPU)
    jmodel.compute_dtype = jnp.float32
    tmodel = teva.TorchEVA02Model(name, props, Device.CPU)
    tmodel.compute_dtype = torch.float32
    jmodel.load()
    tmodel.load()
    return jmodel, tmodel


def test_wrapper_encodes_text_as_jax(both_wrappers):
    jmodel, tmodel = both_wrappers
    texts = ["a cat on a mat", "two dogs", "x"]
    out = tmodel.encode(texts)
    assert out.shape == (3, 24) and tmodel.dimensions == 24
    np.testing.assert_allclose(out, jmodel.encode(texts), atol=1e-5)


def test_wrapper_encodes_images_as_jax(both_wrappers):
    jmodel, tmodel = both_wrappers
    images = [np.random.default_rng(i).integers(
        0, 256, size=(40 + 8 * i, 48, 3)).astype(np.uint8) for i in range(3)]
    out = tmodel.encode(images, modality=Modality.IMAGE)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(
        out, jmodel.encode(images, modality=JaxModality.IMAGE), atol=1e-4)
    for image in images:
        np.testing.assert_array_equal(tmodel._preprocess_host(image),
                                      jmodel._preprocess_host(image))
    with pytest.raises(VectoriseError):
        tmodel.encode(["x"], modality=Modality.AUDIO)


def test_checkpoint_gate_and_its_two_messages(tmp_path, monkeypatch):
    """Without MARQO_ALLOW_UNVERIFIED_CONVERSION a checkpoint is refused
    with the gate's message; with it the loader goes on into conversion
    (and fails there on an empty checkpoint, not at the gate), logging the
    unverified-conversion warning; with neither a checkpoint nor
    random_init the load is refused."""
    torch.save({}, str(tmp_path / "open_clip_pytorch_model.bin"))
    props = {"name": "open_clip/EVA02-B-16/merged2b_s8b_b131k",
             "dimensions": 512, "type": "open_clip",
             "localpath": str(tmp_path / "open_clip_pytorch_model.bin")}
    monkeypatch.delenv("MARQO_ALLOW_UNVERIFIED_CONVERSION", raising=False)
    with pytest.raises(ModelLoadError,
                       match="MARQO_ALLOW_UNVERIFIED_CONVERSION=TRUE to "
                             "load anyway"):
        teva.TorchEVA02Model("eva02", props, Device.CPU).load()
    monkeypatch.setenv("MARQO_ALLOW_UNVERIFIED_CONVERSION", "TRUE")
    warnings = []
    monkeypatch.setattr(teva.logger, "warning", warnings.append)
    with pytest.raises(Exception) as opened:
        teva.TorchEVA02Model("eva02", props, Device.CPU).load()
    assert "MARQO_ALLOW_UNVERIFIED_CONVERSION" not in str(opened.value)
    assert len(warnings) == 1 and "UNVERIFIED" in warnings[0]
    with pytest.raises(ModelLoadError, match="requires an open_clip "
                                             "checkpoint"):
        teva.TorchEVA02Model("eva02", {"dimensions": 8}, Device.CPU).load()


def test_plain_attention_impl_is_the_twin_on_cpu(shared):
    _, model, _, _ = shared
    pixels = torch.from_numpy(_pixels(seed=8))
    kernel = teva.encode_eva02_image(model, pixels)
    wrapper = teva.TorchEVA02Model("x", {}, Device.CPU)
    wrapper.encoder = model
    wrapper.set_attention_impl("plain")
    try:
        assert model.vision.config.attention_impl == "plain"
        assert torch.equal(teva.encode_eva02_image(model, pixels), kernel)
    finally:
        wrapper.set_attention_impl("kernel")


@pytest.mark.parametrize("name", [
    "open_clip/EVA02-B-16/merged2b_s8b_b131k",
    "open_clip/EVA02-L-14/merged2b_s4b_b131k",
    "open_clip/EVA02-L-14-336/merged2b_s6b_b61k",
])
def test_registry_entries_dispatch_and_encode(name):
    """EVA02 registry entries resolve to the port's wrapper as the JAX
    package's resolve to its own, and a random-init model encodes text and
    images in bf16."""
    from marqo_tpu.inference.loaders import \
        resolve_model_class as jax_resolve
    from marqo_tpu_torch.inference.model_registry import \
        get_model_properties_from_registry
    props = dict(get_model_properties_from_registry(name))
    assert jax_resolve(name, props) is jeva.JaxEVA02Model
    assert resolve_model_class(name, props) is teva.TorchEVA02Model
    props.update({"random_init": True, "dimensions": 16, "image_size": 32,
                  "architecture": {"patch_size": 16, "vocab_size": 64}})
    model = load_model(name, props, Device.CPU)
    assert isinstance(model, teva.TorchEVA02Model)
    assert model.encode(["hello", "two dogs"]).shape == (2, 16)
    out = model.encode([np.zeros((40, 24, 3), np.uint8)],
                       modality=Modality.IMAGE)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)
    assert {p.dtype for p in model.encoder.parameters()} == {torch.bfloat16}
