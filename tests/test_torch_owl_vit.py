"""marqo_tpu_torch's OWL-ViT (models/owl_vit.py) against marqo_tpu's and
against transformers' OwlViTForObjectDetection.

The same weights go to every side: marqo_tpu's pytree (every array
perturbed) through ``params_from_jax``, or one random transformers model
through each package's converter. The vision tower has 17 real tokens,
which the JAX package pads to 24 under a mask and the port does not pad.
Tolerances: fp32 logits and boxes within 1e-4 of the JAX package's; bf16
logits at cosine >= 0.999 per image and boxes within 1e-2; against
transformers the JAX package's own bounds (logits 3e-4, boxes 3e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.models import clip as jclip
from marqo_tpu.models import owl_vit as jowl
from marqo_tpu_torch.models import clip as tclip
from marqo_tpu_torch.models import owl_vit as towl

TEXT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_positions=12, projection_dim=32,
            eos_token_id=63, hidden_act="quick_gelu")
VISION = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=2,
              num_heads=2, intermediate_size=64, projection_dim=32,
              hidden_act="quick_gelu")
JCONFIG = jowl.OwlViTConfig(text=jclip.CLIPTextConfig(**TEXT),
                            vision=jclip.CLIPVisionConfig(**VISION))
TCONFIG = towl.OwlViTConfig(text=tclip.CLIPTextConfig(**TEXT),
                            vision=tclip.CLIPVisionConfig(**VISION))


def _ids():
    """Two queries ending with EOS (63) before the pads."""
    ids = np.zeros((2, 12), dtype=np.int32)
    ids[0, :4] = [1, 9, 17, 63]
    ids[1, :3] = [5, 30, 63]
    return ids


def _pixels(n=3, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 32, 32, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32) + 0.05 * rng.standard_normal(
            np.shape(a))).astype(np.float32),
        jowl.init_owl_params(JCONFIG, jax.random.PRNGKey(0)))


def _port_detect(params, dtype, pixels, ids):
    model = towl.params_from_jax(params, TCONFIG, dtype=dtype, device="cpu")
    with torch.inference_mode():
        logits, boxes = towl.detect(model, torch.from_numpy(pixels),
                                    torch.from_numpy(ids))
    return logits.numpy(), boxes.numpy()


def _jax_detect(params, dtype, pixels, ids):
    logits, boxes = jowl.detect(jax.tree.map(jnp.asarray, params),
                                jnp.asarray(pixels), jnp.asarray(ids),
                                JCONFIG, compute_dtype=dtype)
    return np.asarray(logits), np.asarray(boxes)


def test_detect_fp32_matches_jax(params):
    pixels, ids = _pixels(), _ids()
    logits, boxes = _port_detect(params, torch.float32, pixels, ids)
    jlogits, jboxes = _jax_detect(params, jnp.float32, pixels, ids)
    assert logits.shape == (3, 16, 2) and boxes.shape == (3, 16, 4)
    assert logits.dtype == boxes.dtype == np.float32
    np.testing.assert_allclose(logits, jlogits, atol=1e-4, rtol=0)
    np.testing.assert_allclose(boxes, jboxes, atol=1e-4, rtol=0)


def test_detect_bf16_matches_jax(params):
    pixels, ids = _pixels(seed=2), _ids()
    logits, boxes = _port_detect(params, torch.bfloat16, pixels, ids)
    jlogits, jboxes = _jax_detect(params, jnp.bfloat16, pixels, ids)
    a = logits.reshape(3, -1).astype(np.float64)
    b = jlogits.reshape(3, -1).astype(np.float64)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) *
                             np.linalg.norm(b, axis=-1))
    assert cos.min() >= 0.999, cos
    assert np.abs(boxes - jboxes).max() <= 1e-2
    assert boxes.min() >= 0 and boxes.max() <= 1


def _hf_tiny():
    from transformers import OwlViTConfig as HFConfig
    from transformers import OwlViTForObjectDetection
    torch.manual_seed(0)
    cfg = HFConfig(
        text_config={"vocab_size": 64, "hidden_size": 32,
                     "num_hidden_layers": 2, "num_attention_heads": 2,
                     "intermediate_size": 64, "max_position_embeddings": 12,
                     "eos_token_id": 63},
        vision_config={"hidden_size": 32, "num_hidden_layers": 2,
                       "num_attention_heads": 2, "intermediate_size": 64,
                       "image_size": 32, "patch_size": 8},
        projection_dim=32)
    return OwlViTForObjectDetection(cfg).eval()


def test_detect_matches_transformers():
    """transformers groups input_ids per image; detect shares the query set
    across the image batch, so the torch side repeats the queries per
    image (tests/test_owl_vit_parity.py's comparison)."""
    hf = _hf_tiny()
    model = towl.model_from_hf_owlvit(hf.state_dict(), TCONFIG,
                                      device="cpu")
    pixels, ids = _pixels(2), _ids()
    torch_ids = np.tile(ids, (2, 1))
    mean = np.array([0.48145466, 0.4578275, 0.40821073])
    std = np.array([0.26862954, 0.26130258, 0.27577711])
    with torch.no_grad():
        pt = torch.from_numpy((pixels / 255.0 - mean) / std).permute(
            0, 3, 1, 2).float()
        out = hf(input_ids=torch.from_numpy(torch_ids).long(),
                 pixel_values=pt,
                 attention_mask=torch.from_numpy(
                     (torch_ids != 0).astype(np.int64)))
        logits, boxes = towl.detect(model, torch.from_numpy(pixels),
                                    torch.from_numpy(ids))
    np.testing.assert_allclose(logits.numpy(), out.logits.numpy(),
                               atol=3e-4)
    np.testing.assert_allclose(boxes.numpy(), out.pred_boxes.numpy(),
                               atol=3e-5)


def test_hf_converter_matches_jax():
    sd = _hf_tiny().state_dict()
    ours = towl.params_from_hf_owlvit(sd, TCONFIG)
    theirs = jax.tree.map(np.asarray, jowl.params_from_hf_owlvit(sd,
                                                                 JCONFIG))
    flat_ours = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_theirs = dict(jax.tree_util.tree_flatten_with_path(theirs)[0])
    assert len(flat_ours) == len(flat_theirs)
    for path, value in flat_ours:
        assert value.dtype == np.float32
        np.testing.assert_array_equal(value, flat_theirs[path])


@pytest.mark.parametrize("n_side", [4, 7, 24])
def test_compute_box_bias_is_equal(n_side):
    ours = towl.compute_box_bias(n_side)
    assert torch.is_tensor(ours) and ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(jowl.compute_box_bias(n_side)))


def test_random_init_detect_runs():
    model = towl.init_owl_params(TCONFIG, torch.Generator().manual_seed(0),
                                 device="cpu")
    with torch.inference_mode():
        logits, boxes = towl.detect(model, torch.from_numpy(_pixels(1)),
                                    torch.from_numpy(_ids()[:1]))
    assert logits.shape == (1, 16, 1) and boxes.shape == (1, 16, 4)
    assert torch.isfinite(logits).all()
    assert boxes.min() >= 0 and boxes.max() <= 1
