"""The audio pipeline end to end in marqo_tpu_torch (port of
tests/test_audio_e2e.py): WAV decode, log-mel, the audio tower, then ingest
and search through ``tensor_search`` with a random-init LanguageBind-class
model, and a corrupt WAV failing only its own document. Then ROADMAP C2's
check: one index, the same ``.wav`` pointers, through both packages'
``add_documents`` give the same per-document statuses (before C2 was
repaired the port had no ops/audio_ops.py, and every audio pointer failed
there with ModuleNotFoundError).
"""

import wave

import numpy as np
import pytest

from marqo_tpu_torch.api.models.index_settings import IndexSettings
from marqo_tpu_torch.config import Config
from marqo_tpu_torch.core.models.add_docs_params import AddDocsParams
from marqo_tpu_torch.inference import vectorise as inference
from marqo_tpu_torch.inference.types import Device, Modality
from marqo_tpu_torch.ops.audio_ops import (chunk_waveform, load_wav,
                                           log_mel_spectrogram,
                                           mel_filterbank)
from marqo_tpu_torch.tensor_search import tensor_search

LB_PROPS = {
    "type": "languagebind", "dimensions": 24, "random_init": True,
    "image_size": 32,
    "architecture": {"patch_size": 8, "audio_frames": 496,
                     "audio_patch": 16},
    "supported_modalities": ["language", "image", "audio", "video"],
}


def _write_wav(path, freq, duration=2.0, sr=16000):
    t = np.linspace(0, duration, int(sr * duration), endpoint=False)
    data = (0.5 * np.sin(2 * np.pi * freq * t) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(data.tobytes())
    return str(path)


@pytest.fixture
def wavs(tmp_path):
    return {"low": _write_wav(tmp_path / "low.wav", 220),
            "mid": _write_wav(tmp_path / "mid.wav", 880),
            "high": _write_wav(tmp_path / "high.wav", 3520)}


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """This host has no CUDA device: the port serves on the CPU on
    purpose."""
    monkeypatch.setenv("MARQO_BEST_AVAILABLE_DEVICE", "cpu")


class TestAudioOps:
    def test_load_wav(self, wavs):
        data = load_wav(wavs["low"])
        assert data.dtype == np.float32
        assert len(data) == 32000
        assert np.abs(data).max() <= 1.0

    def test_resample(self, tmp_path):
        p = _write_wav(tmp_path / "hi_sr.wav", 440, duration=1.0, sr=44100)
        data = load_wav(p)
        assert abs(len(data) - 16000) <= 1

    def test_log_mel_shape(self, wavs):
        import torch
        wav = torch.from_numpy(load_wav(wavs["mid"]))
        fb = torch.from_numpy(mel_filterbank())
        mel = log_mel_spectrogram(wav, fb, n_frames=200)
        assert mel.shape == (128, 200)
        assert bool(torch.isfinite(mel).all())

    def test_mel_distinguishes_frequencies(self, wavs):
        import torch
        fb = torch.from_numpy(mel_filterbank())
        low = log_mel_spectrogram(torch.from_numpy(load_wav(wavs["low"])),
                                  fb, 200).numpy()
        high = log_mel_spectrogram(torch.from_numpy(load_wav(wavs["high"])),
                                   fb, 200).numpy()
        # energy concentrates in different mel bands
        assert np.argmax(low.mean(axis=1)) < np.argmax(high.mean(axis=1))

    def test_chunk_waveform(self):
        wav = np.zeros(16000 * 25, dtype=np.float32)  # 25 s
        chunks = chunk_waveform(wav, split_length_s=10, split_overlap_s=3)
        assert len(chunks) == 4  # starts at 0, 7, 14, 21
        assert all(len(p) == 160000 for (_s, _e, p) in chunks)


class TestLanguageBindModel:
    def test_all_modalities_one_space(self, wavs):
        from marqo_tpu_torch.models.languagebind import \
            TorchLanguageBindModel
        model = TorchLanguageBindModel("lb-test", LB_PROPS, Device.CPU)
        model.load()
        t = model.encode(["a low hum"], modality=Modality.TEXT)
        a = model.encode([load_wav(wavs["low"])], modality=Modality.AUDIO)
        img = np.zeros((40, 40, 3), dtype=np.uint8)
        v = model.encode([img], modality=Modality.IMAGE)
        vid = model.encode([[img, img]], modality=Modality.VIDEO)
        assert t.shape == a.shape == v.shape == vid.shape == (1, 24)
        for out in (t, a, v, vid):
            np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0,
                                       atol=1e-4)

    def test_audio_deterministic_and_distinct(self, wavs):
        from marqo_tpu_torch.models.languagebind import \
            TorchLanguageBindModel
        model = TorchLanguageBindModel("lb-test", LB_PROPS, Device.CPU)
        model.load()
        a1 = model.encode([wavs["low"]], modality=Modality.AUDIO)
        a2 = model.encode([wavs["low"]], modality=Modality.AUDIO)
        b = model.encode([wavs["high"]], modality=Modality.AUDIO)
        np.testing.assert_allclose(a1, a2, atol=2e-3)
        assert float((a1 * b).sum()) < 0.999


def _audio_index(config_cls, settings_cls, name="audio-idx"):
    cfg = config_cls()
    cfg.index_management.bootstrap()
    settings = settings_cls(model="my-lb", modelProperties=LB_PROPS,
                            treatUrlsAndPointersAsImages=True,
                            treatUrlsAndPointersAsMedia=True,
                            audioPreprocessing={"splitLength": 1,
                                                "splitOverlap": 0})
    cfg.index_management.create_index(settings.to_marqo_index(name))
    cfg.index_meta_cache.populate()
    return cfg


class TestAudioIngestSearch:
    @pytest.fixture
    def config(self):
        inference.clear_loaded_models()
        cfg = _audio_index(Config, IndexSettings)
        yield cfg
        cfg.index_meta_cache.stop_refresh_thread()
        inference.clear_loaded_models()

    def test_add_and_search_audio(self, config, wavs):
        docs = [{"_id": name, "sound": path} for name, path in wavs.items()]
        res = tensor_search.add_documents(config, AddDocsParams(
            index_name="audio-idx", docs=docs, tensor_fields=["sound"]))
        assert res["errors"] is False, res["items"]
        # 2 s clips split into 1 s chunks → 2 chunks per doc
        assert config.engine.vector_count("audio-idx") == 6
        out = tensor_search.search(config, "audio-idx", text=wavs["low"])
        assert out["hits"][0]["_id"] == "low"
        # highlight carries the [start, end] chunk
        assert out["hits"][0]["_highlights"][0]["sound"].startswith("[")

    def test_bad_audio_isolated(self, config, wavs, tmp_path):
        bad = tmp_path / "corrupt.wav"
        bad.write_bytes(b"RIFFxxxxWAVEjunk")
        docs = [{"_id": "ok", "sound": wavs["mid"]},
                {"_id": "bad", "sound": str(bad)}]
        res = tensor_search.add_documents(config, AddDocsParams(
            index_name="audio-idx", docs=docs, tensor_fields=["sound"]))
        statuses = {i["_id"]: i["status"] for i in res["items"]}
        assert statuses["ok"] == 200
        assert statuses["bad"] == 400


def test_wav_pointer_status_matches_the_jax_package(wavs, tmp_path):
    """ROADMAP C2: the same LanguageBind random-init index in both
    packages, the same documents (three .wav pointers, a corrupt one and a
    missing one): every document gets the same status, and the good
    pointers their two 1 s chunks each."""
    from marqo_tpu.api.models.index_settings import \
        IndexSettings as JaxIndexSettings
    from marqo_tpu.config import Config as JaxConfig
    from marqo_tpu.core.models.add_docs_params import \
        AddDocsParams as JaxAddDocsParams
    from marqo_tpu.inference import vectorise as jax_inference
    from marqo_tpu.tensor_search import tensor_search as jax_tensor_search
    bad = tmp_path / "corrupt.wav"
    bad.write_bytes(b"RIFFxxxxWAVEjunk")
    docs = [{"_id": name, "sound": path} for name, path in wavs.items()]
    docs += [{"_id": "bad", "sound": str(bad)},
             {"_id": "missing", "sound": str(tmp_path / "missing.wav")}]
    results = {}
    for package, (config_cls, settings_cls, params_cls, search, models) in {
            "jax": (JaxConfig, JaxIndexSettings, JaxAddDocsParams,
                    jax_tensor_search, jax_inference),
            "torch": (Config, IndexSettings, AddDocsParams, tensor_search,
                      inference)}.items():
        models.clear_loaded_models()
        cfg = _audio_index(config_cls, settings_cls)
        try:
            res = search.add_documents(cfg, params_cls(
                index_name="audio-idx", docs=[dict(d) for d in docs],
                tensor_fields=["sound"]))
            results[package] = (
                res["errors"], {i["_id"]: i["status"] for i in res["items"]},
                cfg.engine.vector_count("audio-idx"))
        finally:
            cfg.index_meta_cache.stop_refresh_thread()
            models.clear_loaded_models()
    assert results["torch"] == results["jax"]
    errors, statuses, vectors = results["torch"]
    assert errors is True and vectors == 6
    assert statuses == {"low": 200, "mid": 200, "high": 200, "bad": 400,
                        "missing": 400}
