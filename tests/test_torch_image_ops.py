"""marqo_tpu_torch image preprocessing (ops/image_ops.py) against the JAX
package's, on the CPU.

The tensor functions (resize, crop, normalize, preprocess) agree with
``jax.image`` at atol 1e-5 (float32) in pixel units on [0, 1]: bicubic
with antialias, down- and upscaling, landscape and portrait. The
preprocessed outputs are divided by CLIP_STD (about 0.27), which scales the
resize's rounding by up to 3.8, so they are compared times CLIP_STD.
``host_decode`` is a copy of the reference's and gives identical arrays.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from marqo_tpu.ops import image_ops as jax_ops
from marqo_tpu_torch.ops import image_ops as ops

STD = np.asarray(ops.CLIP_STD, dtype=np.float32)

# (H, W) → target: downscale and upscale, both orientations
SIZES = [((64, 48), 32), ((48, 64), 32), ((24, 20), 32), ((20, 24), 32),
         ((300, 200), 224), ((120, 160), 224), ((33, 33), 16)]


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("hw,target", SIZES)
def test_resize_shorter_side_matches_jax(hw, target):
    x = _image(*hw, seed=hw[0]).astype(np.float32) / 255.0
    ref = np.asarray(jax_ops.resize_shorter_side(jnp.asarray(x), target))
    out = ops.resize_shorter_side(torch.from_numpy(x), target).numpy()
    assert out.shape == ref.shape and min(out.shape[:2]) == target
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("hw", [(40, 30), (30, 40), (32, 32)])
def test_center_crop_and_normalize_match_jax(hw):
    x = _image(*hw, seed=1).astype(np.float32) / 255.0
    crop = ops.center_crop(torch.from_numpy(x), 24)
    np.testing.assert_array_equal(
        crop.numpy(), np.asarray(jax_ops.center_crop(jnp.asarray(x), 24)))
    np.testing.assert_allclose(
        ops.normalize(crop).numpy(),
        np.asarray(jax_ops.normalize(jnp.asarray(crop.numpy()))), atol=1e-6)


@pytest.mark.parametrize("hw,target", SIZES)
def test_preprocess_image_matches_jax(hw, target):
    image = _image(*hw, seed=hw[1])
    ref = np.asarray(jax_ops.preprocess_image(jnp.asarray(image), target))
    out = ops.preprocess_image(torch.from_numpy(image), target)
    assert out.dtype == torch.float32 and out.shape == (target, target, 3)
    np.testing.assert_allclose(out.numpy() * STD, ref * STD, atol=1e-5)


@pytest.mark.parametrize("hw", [(50, 70), (70, 50)])
def test_preprocess_batch_matches_jax(hw):
    images = np.stack([_image(*hw, seed=s) for s in range(3)])
    ref = np.asarray(jax_ops.preprocess_batch(jnp.asarray(images), 32))
    out = ops.preprocess_batch(torch.from_numpy(images), 32)
    assert out.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(out.numpy() * STD, ref * STD, atol=1e-5)


def test_constants_are_the_reference_constants():
    assert ops.CLIP_MEAN == jax_ops.CLIP_MEAN
    assert ops.CLIP_STD == jax_ops.CLIP_STD


# --- host_decode -------------------------------------------------------------

def _decode_both(content):
    out = ops.host_decode(content)
    np.testing.assert_array_equal(out, jax_ops.host_decode(content))
    assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 3
    return out


def test_host_decode_applies_exif_orientation():
    img = Image.fromarray(_image(20, 40, seed=2))
    exif = img.getexif()
    exif[0x0112] = 6  # rotate 90° clockwise on display
    buf = io.BytesIO()
    img.save(buf, "JPEG", exif=exif.tobytes())
    out = _decode_both(buf.getvalue())
    assert out.shape == (40, 20, 3)


def test_host_decode_passes_uint8_ndarrays_through():
    array = _image(8, 6, seed=3)
    assert ops.host_decode(array) is array


def test_host_decode_refuses_other_ndarrays_and_types():
    with pytest.raises(ValueError, match="uint8"):
        ops.host_decode(np.zeros((4, 4, 3), dtype=np.float32))
    with pytest.raises(ValueError, match="Unsupported"):
        ops.host_decode(12)


def test_host_decode_bytes_path_and_pil(tmp_path):
    array = _image(10, 14, seed=4)
    img = Image.fromarray(array)
    buf = io.BytesIO()
    img.save(buf, "PNG")
    path = tmp_path / "img.png"
    img.save(path)
    for content in (buf.getvalue(), str(path), img, img.convert("L")):
        out = _decode_both(content)
        assert out.shape == (10, 14, 3)
    np.testing.assert_array_equal(ops.host_decode(str(path)), array)
