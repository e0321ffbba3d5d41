"""marqo_tpu_torch's LanguageBind (models/languagebind.py) against
marqo_tpu's.

The same weights go to both packages: marqo_tpu's towers (every array
perturbed, so a dropped bias shows) through the port's ``*_from_jax``
builders, or one LanguageBindVideo state dict (the torch mirror of
tests/test_languagebind_video_parity.py, HF CLIP naming plus the temporal
keys) through each package's converter. The wrappers are held against each
other on all four modalities: text, image, audio (a waveform, WAV bytes and
a path) and video, through the temporal tower and through the random-init
fallback (the mean of the frames' image embeddings). Inputs are made with
numpy from a seed. Tolerances: the video tower atol 3e-5 (the reference's
own), the other towers fp32 cosine > 1 - 1e-5 with atol 1e-4, bf16 cosine
> 1 - 1e-3. On the CPU the towers' attention is kernel B2's plain twin.
"""

import dataclasses
import io
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.inference.types import Device as JaxDevice
from marqo_tpu.inference.types import Modality as JaxModality
from marqo_tpu.models import languagebind as jlb
from marqo_tpu_torch.core.exceptions import ModelLoadError, VectoriseError
from marqo_tpu_torch.inference.loaders import load_model, resolve_model_class
from marqo_tpu_torch.inference.types import Device, Modality
from marqo_tpu_torch.models import languagebind as tlb
from tests.test_languagebind_video_parity import (TINY, _make_state_dict,
                                                  _torch_forward)

AUDIO = jlb.AudioTowerConfig(n_frames=96, patch_size=16, hidden_size=32,
                             num_layers=2, num_heads=2, intermediate_size=64,
                             projection_dim=24)


def _port(config):
    cls = {jlb.AudioTowerConfig: tlb.AudioTowerConfig,
           jlb.VideoTowerConfig: tlb.VideoTowerConfig}[type(config)]
    return cls(**dataclasses.asdict(config))


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32) + 0.02 *
                                   rng.standard_normal(np.shape(a))
                                   ).astype(np.float32), tree)


def _cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) *
                              np.linalg.norm(b, axis=-1))


def _close(out, ref, atol=1e-4):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert (_cosines(out, ref) > 1 - 1e-5).all()
    np.testing.assert_allclose(out, ref, atol=atol, rtol=1e-4)


def _frames(seed=0, B=2, T=3, size=32):
    return np.random.default_rng(seed).integers(
        0, 256, (B, T, size, size, 3)).astype(np.uint8)


# --- the audio tower ---------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 3])
def test_audio_tower_matches_jax(channels):
    config = dataclasses.replace(AUDIO, channels=channels)
    params = _perturbed(jlb.init_audio_tower(config, jax.random.PRNGKey(1)),
                        2)
    tower = tlb.audio_tower_from_jax(params, _port(config), device="cpu")
    mels = np.random.default_rng(3).standard_normal(
        (3, 128, 96)).astype(np.float32)
    ref = np.asarray(jlb.encode_audio_tower(
        jax.tree.map(jnp.asarray, params), jnp.asarray(mels), config,
        compute_dtype=jnp.float32))
    out = tlb.encode_audio_tower(tower, torch.from_numpy(mels))
    assert out.dtype == torch.float32 and tuple(out.shape) == (3, 24)
    _close(out.numpy(), ref)
    # 128 mels x 96 frames at patch 16: 8 x 6 patches and the class token
    assert tuple(tower.position_embedding.shape) == (49, 32)


def test_audio_tower_bf16_tracks_jax():
    params = _perturbed(jlb.init_audio_tower(AUDIO, jax.random.PRNGKey(4)),
                        5)
    tower = tlb.audio_tower_from_jax(params, _port(AUDIO),
                                     dtype=torch.bfloat16, device="cpu")
    mels = np.random.default_rng(6).standard_normal(
        (2, 128, 96)).astype(np.float32)
    ref = jlb.encode_audio_tower(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params),
        jnp.asarray(mels), AUDIO)
    out = tlb.encode_audio_tower(tower, torch.from_numpy(mels))
    assert (_cosines(out.numpy(), np.asarray(ref, np.float32))
            > 1 - 1e-3).all()


# --- the video tower ---------------------------------------------------------

@pytest.mark.parametrize("time_attn", [True, False],
                         ids=["temporal", "no_temporal"])
def test_video_tower_matches_jax(time_attn):
    config = dataclasses.replace(TINY, add_time_attn=time_attn)
    params = _perturbed(jlb.init_video_tower(config, jax.random.PRNGKey(7)),
                        8)
    tower = tlb.video_tower_from_jax(params, _port(config), device="cpu")
    assert (tower.temporal is not None) == time_attn
    frames = _frames(seed=9)
    ref = np.asarray(jlb.encode_video_tower(
        jax.tree.map(jnp.asarray, params), jnp.asarray(frames), config,
        compute_dtype=jnp.float32))
    out = tlb.encode_video_tower(tower, torch.from_numpy(frames)).numpy()
    assert out.shape == (2, 24)
    np.testing.assert_allclose(out, ref, atol=3e-5)


def test_video_tower_bf16_tracks_jax():
    params = _perturbed(jlb.init_video_tower(TINY, jax.random.PRNGKey(10)),
                        11)
    tower = tlb.video_tower_from_jax(params, _port(TINY),
                                     dtype=torch.bfloat16, device="cpu")
    frames = _frames(seed=12)
    ref = jlb.encode_video_tower(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params),
        jnp.asarray(frames), TINY)
    out = tlb.encode_video_tower(tower, torch.from_numpy(frames))
    assert (_cosines(out.numpy(), np.asarray(ref, np.float32))
            > 1 - 1e-3).all()


def test_converter_matches_jax_and_the_reference_forward():
    """params_from_languagebind_video through the torch mirror of the
    reference forward (modeling_video.py): the converted leaves equal the
    JAX package's, and the port's tower reproduces the mirror."""
    torch.manual_seed(0)
    sd = _make_state_dict(TINY)
    ref_params = jlb.params_from_languagebind_video(sd, TINY,
                                                    dtype=jnp.float32)
    params = tlb.params_from_languagebind_video(sd, _port(TINY))
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref_params)
    out_leaves = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(ref_leaves) == len(out_leaves)
    for path, value in ref_leaves:
        assert out_leaves[path].dtype == np.float32
        np.testing.assert_array_equal(out_leaves[path], np.asarray(value),
                                      err_msg=str(path))
    tower = tlb.video_tower_from_jax(params, _port(TINY), device="cpu")
    frames = _frames(seed=13)
    with torch.no_grad():
        expected = _torch_forward(sd, TINY, frames).numpy()
    out = tlb.encode_video_tower(tower, torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(out, expected, atol=3e-5)


def test_temporal_attention_sees_frame_order():
    tower = tlb.init_video_tower(_port(TINY), torch.Generator().manual_seed(0),
                                 device="cpu")
    frames = _frames(seed=14, B=1)
    a = tlb.encode_video_tower(tower, torch.from_numpy(frames))
    b = tlb.encode_video_tower(tower,
                               torch.from_numpy(frames[:, [1, 0, 2]].copy()))
    assert float((a - b).abs().max()) > 1e-6


# --- the wrapper -------------------------------------------------------------

PROPS = {"type": "languagebind", "dimensions": 24, "random_init": True,
         "image_size": 32,
         "architecture": {"patch_size": 8, "audio_frames": 96,
                          "audio_patch": 16, "vocab_size": 64},
         "supported_modalities": ["language", "image", "audio", "video"]}


def _wav_bytes(freq, seconds=1.5, sr=16000):
    """A tone under noise, as 16-bit PCM. (A pure tone leaves mel bins
    near the 1e-10 floor, where the log amplifies the FFTs' last-digit
    differences past 1e-4.)"""
    t = np.arange(int(sr * seconds)) / sr
    noise = np.random.default_rng(freq).standard_normal(len(t))
    data = ((0.5 * np.sin(2 * np.pi * freq * t) + 0.02 * noise) *
            32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(data.tobytes())
    return buf.getvalue()


@pytest.fixture(scope="module")
def both_wrappers():
    """A random-init JAX wrapper in fp32, and the port's wrapper holding
    the JAX wrapper's weights (its own random init replaced)."""
    jmodel = jlb.JaxLanguageBindModel("lb-test", PROPS, JaxDevice.CPU)
    jmodel.compute_dtype = jnp.float32
    jmodel.load()
    tmodel = tlb.TorchLanguageBindModel("lb-test", PROPS, Device.CPU)
    tmodel.load()
    tmodel.encoder = tlb.params_from_jax(
        jax.tree.map(np.asarray, jmodel.params), tmodel.text_config,
        tmodel.vision_config, tmodel.audio_config, device="cpu")
    return jmodel, tmodel


IMAGES = [np.random.default_rng(i).integers(
    0, 256, (40, 40 + 8 * i, 3)).astype(np.uint8) for i in range(3)]


def test_wrapper_text_and_images_match_jax(both_wrappers):
    jmodel, tmodel = both_wrappers
    texts = ["a low hum", "birdsong at dawn", "x"]
    out = tmodel.encode(texts)
    assert out.shape == (3, 24)
    np.testing.assert_allclose(out, jmodel.encode(texts), atol=1e-5)
    np.testing.assert_allclose(
        tmodel.encode(IMAGES, modality=Modality.IMAGE),
        jmodel.encode(IMAGES, modality=JaxModality.IMAGE), atol=1e-4)


def test_wrapper_audio_matches_jax(both_wrappers, tmp_path):
    jmodel, tmodel = both_wrappers
    path = tmp_path / "tone.wav"
    path.write_bytes(_wav_bytes(880))
    wave_np = tlb.load_wav(str(path))
    contents = [wave_np, _wav_bytes(220), str(path)]
    for content in contents:
        np.testing.assert_allclose(tmodel._prep_audio(content),
                                   jmodel._prep_audio(content), atol=1e-4)
    out = tmodel.encode(contents, modality=Modality.AUDIO)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(
        out, jmodel.encode(contents, modality=JaxModality.AUDIO), atol=1e-4)
    with pytest.raises(VectoriseError, match="Unsupported audio content"):
        tmodel.encode([np.zeros((2, 2))], modality=Modality.AUDIO)


def test_wrapper_video_falls_back_to_the_frame_mean_as_jax(both_wrappers):
    """Without converted video weights a video is the mean of its frames'
    image embeddings; a single frame array is one frame."""
    jmodel, tmodel = both_wrappers
    assert tmodel.encoder.video is None
    videos = [IMAGES, [IMAGES[0]], IMAGES[1]]
    out = tmodel.encode(videos, modality=Modality.VIDEO)
    np.testing.assert_allclose(
        out, jmodel.encode(videos, modality=JaxModality.VIDEO), atol=1e-4)
    frame_mean = tmodel.encode(IMAGES, modality=Modality.IMAGE,
                               normalize=False).mean(0)
    np.testing.assert_allclose(
        out[0], frame_mean / np.linalg.norm(frame_mean), atol=1e-5)
    for bad in ([], "not frames"):
        with pytest.raises(VectoriseError):
            tmodel.encode([bad], modality=Modality.VIDEO)


def test_wrapper_video_tower_matches_jax(both_wrappers, monkeypatch):
    """With video weights the temporal tower runs one video per call; a
    short clip repeats its last frame up to num_frames, a long one is
    cut."""
    jmodel, tmodel = both_wrappers
    config = dataclasses.replace(TINY, projection_dim=24)
    params = _perturbed(jlb.init_video_tower(config, jax.random.PRNGKey(15)),
                        16)
    monkeypatch.setitem(jmodel.params, "video",
                        jax.tree.map(jnp.asarray, params))
    monkeypatch.setattr(jmodel, "video_config", config, raising=False)
    monkeypatch.setattr(tmodel, "video_config", _port(config))
    monkeypatch.setattr(tmodel.encoder, "video", tlb.video_tower_from_jax(
        params, _port(config), device="cpu"))
    videos = [IMAGES[:2], IMAGES + IMAGES[:1]]
    out = tmodel.encode(videos, modality=Modality.VIDEO)
    np.testing.assert_allclose(
        out, jmodel.encode(videos, modality=JaxModality.VIDEO), atol=1e-4)


def test_unsupported_modality_is_refused():
    model = tlb.TorchLanguageBindModel(
        "lb", dict(PROPS, supported_modalities=["language", "audio"]),
        Device.CPU)
    model.load()
    assert model.encode(["hi"]).shape == (1, 24)
    with pytest.raises(VectoriseError):
        model.encode(IMAGES[:1], modality=Modality.IMAGE)


def test_load_without_weights_is_refused():
    with pytest.raises(ModelLoadError, match="localpaths"):
        tlb.TorchLanguageBindModel("lb", {"dimensions": 8},
                                   Device.CPU).load()


def test_localpaths_image_checkpoint_loads_as_jax(tmp_path):
    """A converted LanguageBind_Image directory (an HF CLIPModel) loads
    the text and image towers in both packages alike."""
    transformers = pytest.importorskip("transformers")
    config = transformers.CLIPConfig(
        text_config=dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=64,
                         max_position_embeddings=77, eos_token_id=63),
        vision_config=dict(image_size=32, patch_size=8, hidden_size=32,
                           num_hidden_layers=2, num_attention_heads=2,
                           intermediate_size=64),
        projection_dim=24)
    torch.manual_seed(0)
    transformers.CLIPModel(config).save_pretrained(str(tmp_path))
    props = {"type": "languagebind", "dimensions": 24,
             "localpaths": {"image": str(tmp_path)}}
    jmodel = jlb.JaxLanguageBindModel("lb-img", props, JaxDevice.CPU)
    jmodel.compute_dtype = jnp.float32
    jmodel.load()
    tmodel = tlb.TorchLanguageBindModel("lb-img", props, Device.CPU)
    tmodel.compute_dtype = torch.float32
    tmodel.load()
    assert tmodel.encoder.audio is None and tmodel.encoder.video is None
    texts = ["a cat", "two dogs"]
    np.testing.assert_allclose(tmodel.encode(texts), jmodel.encode(texts),
                               atol=1e-5)
    np.testing.assert_allclose(
        tmodel.encode(IMAGES, modality=Modality.IMAGE),
        jmodel.encode(IMAGES, modality=JaxModality.IMAGE), atol=1e-4)


@pytest.mark.parametrize("name", [
    "LanguageBind/Video_V1.5_FT_Audio_FT_Image",
    "LanguageBind/Video_V1.5_FT_Audio_FT",
    "LanguageBind/Video_V1.5_FT_Image",
    "LanguageBind/Audio_FT_Image",
    "LanguageBind/Audio_FT",
    "LanguageBind/Video_V1.5_FT",
])
def test_registry_entries_dispatch_and_encode(name):
    """LanguageBind registry entries resolve to the port's wrapper as the
    JAX package's resolve to its own, and a random-init bf16 model embeds
    text and each modality the entry supports."""
    from marqo_tpu.inference.loaders import \
        resolve_model_class as jax_resolve
    from marqo_tpu_torch.inference.model_registry import \
        get_model_properties_from_registry
    props = dict(get_model_properties_from_registry(name))
    assert jax_resolve(name, props) is jlb.JaxLanguageBindModel
    assert resolve_model_class(name, props) is tlb.TorchLanguageBindModel
    props.update({k: v for k, v in PROPS.items()
                  if k != "supported_modalities"})
    model = load_model(name, props, Device.CPU)
    assert model.encode(["hello"]).shape == (1, 24)
    contents = {Modality.IMAGE: IMAGES[:1], Modality.VIDEO: [IMAGES[:2]],
                Modality.AUDIO: [_wav_bytes(440)]}
    for modality, content in contents.items():
        if modality.value in model.supported:
            out = model.encode(content, modality=modality)
            np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0,
                                       atol=1e-3)
    assert {p.dtype for p in model.encoder.parameters()} == {torch.bfloat16}
