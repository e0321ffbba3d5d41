"""The detector patch methods end to end, through marqo_tpu_torch's and
marqo_tpu's ``chunk_image`` on the same weights, on the CPU
(tests/test_torch_patching_index.py adds documents to an index with each
method).

Each package draws its own random detector weights (a torch.Generator in
the port, a JAX key in marqo_tpu), so the port's patchers here hold the
JAX patchers' weights, carried across with each model's
``params_from_jax``. Faster R-CNN runs at width 0.125 (MARQO_FRCNN_WIDTH)
and YOLOX-S's graph at width 0.125 in both packages: at full width the JAX
package's compile alone takes most of a minute on a CPU. YOLOX and Faster
R-CNN compute in fp32 in both packages and give identical chunk strings.
DINO serves in bf16, where the port's blocks round their attention scores
differently (fp32 on the twin): its boxes are compared from fp32 maps, in
both packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from marqo_tpu.core.exceptions import ModelLoadError as JaxModelLoadError
from marqo_tpu.inference import image_patching as jpatch
from marqo_tpu.models import dino_vit as jdino
from marqo_tpu.models import yolox as jyolo
from marqo_tpu_torch.core.exceptions import ModelLoadError
from marqo_tpu_torch.inference import image_patching as tpatch
from marqo_tpu_torch.models import dino_vit as tdino
from marqo_tpu_torch.models import frcnn as tfrcnn
from marqo_tpu_torch.models import yolox as tyolo

METHODS = ("dino-v1", "dino-v2", "marqo-yolo", "yolox", "frcnn")


@pytest.fixture(autouse=True)
def environment(monkeypatch):
    # this host has no CUDA device: the port serves on the CPU on purpose
    monkeypatch.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")
    monkeypatch.setenv("MARQO_PATCH_MODELS_RANDOM_INIT", "TRUE")
    monkeypatch.setenv("MARQO_FRCNN_WIDTH", "0.125")
    jpatch.clear_patchers()
    tpatch.clear_patchers()
    yield
    jpatch.clear_patchers()
    tpatch.clear_patchers()


def _numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _patcher_pair(method):
    """Load marqo_tpu's random-init patcher for ``method`` and the port's,
    and give the port's its weights (fp32 models)."""
    jax_patcher = jpatch._get_patcher(method)
    port = tpatch._get_patcher(method)
    if method in ("marqo-yolo", "yolox"):
        jax_patcher.config = jyolo.YoloxConfig(width=0.125)
        jax_patcher.params = jyolo.init_params(jax_patcher.config,
                                               jax.random.PRNGKey(0))
        port.config = tyolo.YoloxConfig(width=0.125)
    params = _numpy(jax_patcher.params)
    if method.startswith("dino"):
        port.model = tdino.params_from_jax(params, port.config,
                                           device="cpu")
    elif method == "frcnn":
        port.model = tfrcnn.params_from_jax(params, port.config,
                                            device="cpu")
    else:
        port.model = tyolo.params_from_jax(params, port.config,
                                           device="cpu")


@pytest.fixture
def fp32_dino(monkeypatch):
    """The JAX DINO patcher computing its maps in fp32."""
    monkeypatch.setattr(jdino, "last_selfattention_jit", functools.partial(
        jdino.last_selfattention_jit, compute_dtype=jnp.float32))


def _image(seed, h=180, w=300):
    """A smooth field with two bright blobs, so the detectors' maps have
    structure to threshold."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3), np.float32) + rng.uniform(20, 80, 3)
    for _ in range(2):
        cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) /
                      (2 * (0.1 * min(h, w)) ** 2))
        img += blob[..., None] * rng.uniform(100, 175, 3)
    img += rng.normal(0, 8, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("method", METHODS)
def test_chunk_image_matches_jax(method, fp32_dino):
    _patcher_pair(method)
    for seed, (h, w) in ((1, (180, 300)), (2, (240, 160))):
        image = _image(seed, h, w)
        patches, chunks = tpatch.chunk_image(image, method)
        jpatches, jchunks = jpatch.chunk_image(image, method)
        assert chunks == jchunks
        assert chunks[0] == str([0, 0, w, h])
        for patch, jp in zip(patches, jpatches):
            np.testing.assert_array_equal(patch, jp)


@pytest.mark.parametrize("method, match", [
    ("dino-v1", "MARQO_DINO_WEIGHTS_PATH"),
    ("marqo-yolo", "yolox_s.onnx"),
    ("frcnn", "fasterrcnn_resnet50_fpn")])
def test_weights_gated_without_random_init(method, match, monkeypatch):
    monkeypatch.setenv("MARQO_PATCH_MODELS_RANDOM_INIT", "FALSE")
    image = _image(3)
    with pytest.raises(ModelLoadError, match=match) as ours:
        tpatch.chunk_image(image, method)
    with pytest.raises(JaxModelLoadError) as theirs:
        jpatch.chunk_image(image, method)
    assert str(ours.value) == str(theirs.value)
