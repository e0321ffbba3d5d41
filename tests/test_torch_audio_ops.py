"""marqo_tpu_torch's audio ops (ops/audio_ops.py) against marqo_tpu's.

The numpy functions (``load_wav``, ``mel_filterbank``, ``chunk_waveform``)
are copies and must give equal results; the torch log-mel must stay within
atol 1e-4 of the JAX one at (128 mels, 200 frames). One case per trap of
the rewrite: a waveform shorter than the frames need is TILED (as
``jnp.resize``), not zero-padded; the window is the SYMMETRIC Hann window
(``jnp.hanning``); frames are taken by index with no centring (what
``torch.stft`` would do differs). Each trap's wrong variant is shown to
miss the JAX output by more than the tolerance, so the checks can see it.
Inputs are made with numpy from a seed.
"""

import io
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marqo_tpu.ops import audio_ops as ja
from marqo_tpu_torch.ops import audio_ops as ta

N_FRAMES = 200
NEEDED = (N_FRAMES - 1) * ta.HOP_LENGTH + ta.WIN_LENGTH  # 32240 samples
ATOL = 1e-4


def _waveform(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / ta.SAMPLE_RATE
    return (0.3 * np.sin(2 * np.pi * 440 * t) +
            0.05 * rng.standard_normal(n)).astype(np.float32)


def _jax_log_mel(wav, n_mels=ta.N_MELS, n_frames=N_FRAMES):
    return np.asarray(ja.log_mel_spectrogram(
        jnp.asarray(wav), jnp.asarray(ja.mel_filterbank(n_mels)), n_frames))


def _torch_log_mel(wav, n_mels=ta.N_MELS, n_frames=N_FRAMES):
    return ta.log_mel_spectrogram(
        torch.from_numpy(wav), torch.from_numpy(ta.mel_filterbank(n_mels)),
        n_frames).numpy()


def _numpy_log_mel(frames, window, n_mels=ta.N_MELS):
    """The chain after framing, in numpy float64: window, |rfft|^2, mel,
    log, global normalisation → (n_mels, n_frames)."""
    spec = np.fft.rfft(frames * window, n=ta.N_FFT, axis=-1)
    mel = (np.abs(spec) ** 2) @ ta.mel_filterbank(n_mels).astype(np.float64)
    logmel = np.log(np.maximum(mel, 1e-10))
    return ((logmel - logmel.mean()) / max(logmel.std(), 1e-5)).T


def _index_frames(wav):
    idx = (np.arange(N_FRAMES)[:, None] * ta.HOP_LENGTH +
           np.arange(ta.WIN_LENGTH)[None, :])
    return wav[idx].astype(np.float64)


@pytest.mark.parametrize("n_mels", [128, 112, 64])
def test_filterbank_equals_jax(n_mels):
    out = ta.mel_filterbank(n_mels)
    assert out.dtype == np.float32 and out.shape == (ta.N_FFT // 2 + 1,
                                                     n_mels)
    np.testing.assert_array_equal(out, ja.mel_filterbank(n_mels))


@pytest.mark.parametrize("n", [NEEDED + 7777, NEEDED, 12345, 1001],
                         ids=["longer", "exact", "short", "short_odd"])
def test_log_mel_matches_jax(n):
    wav = _waveform(n, seed=n)
    ref = _jax_log_mel(wav)
    out = _torch_log_mel(wav)
    assert out.shape == (128, N_FRAMES) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_short_input_wraps_instead_of_padding():
    """An odd-length clip shorter than the frames need is repeated end to
    end, as jnp.resize does; zero-padding it instead misses the JAX
    output."""
    wav = _waveform(1001, seed=1)
    tiled = ta.tile_to_length(torch.from_numpy(wav), NEEDED).numpy()
    np.testing.assert_array_equal(tiled, np.resize(wav, NEEDED))
    np.testing.assert_array_equal(
        tiled, np.asarray(jnp.resize(jnp.asarray(wav), (NEEDED,))))
    ref = _jax_log_mel(wav)
    np.testing.assert_allclose(_torch_log_mel(wav), ref, atol=ATOL)
    padded = np.pad(wav, (0, NEEDED - len(wav)))
    wrong = _numpy_log_mel(_index_frames(padded), np.hanning(ta.WIN_LENGTH))
    assert np.abs(wrong - ref).max() > 100 * ATOL


def test_empty_waveform_tiles_to_zeros_as_jax():
    assert torch.equal(ta.tile_to_length(torch.zeros(0), 5), torch.zeros(5))
    np.testing.assert_array_equal(
        np.asarray(jnp.resize(jnp.zeros((0,)), (5,))), np.zeros(5))


def test_window_is_the_symmetric_hann():
    """jnp.hanning is symmetric (torch.hann_window(periodic=False)); the
    periodic window torch defaults to misses the JAX output."""
    np.testing.assert_allclose(
        torch.hann_window(ta.WIN_LENGTH, periodic=False).numpy(),
        np.asarray(jnp.hanning(ta.WIN_LENGTH)), atol=1e-6)
    wav = _waveform(NEEDED, seed=2)
    ref = _jax_log_mel(wav)
    frames = _index_frames(wav)
    right = _numpy_log_mel(frames, np.hanning(ta.WIN_LENGTH))
    np.testing.assert_allclose(right, ref, atol=ATOL)
    periodic = torch.hann_window(ta.WIN_LENGTH, periodic=True).double()
    wrong = _numpy_log_mel(frames, periodic.numpy())
    assert np.abs(wrong - ref).max() > 10 * ATOL


def test_frames_are_taken_by_index_without_centring():
    """Frame i starts at sample 160 i; torch.stft's centred, reflect-padded
    frames (its default) give another spectrogram."""
    wav = _waveform(NEEDED, seed=3)
    ref = _jax_log_mel(wav)
    window = np.hanning(ta.WIN_LENGTH)
    np.testing.assert_allclose(_numpy_log_mel(_index_frames(wav), window),
                               ref, atol=ATOL)
    spec = torch.stft(torch.from_numpy(wav).double(), n_fft=ta.N_FFT,
                      hop_length=ta.HOP_LENGTH, win_length=ta.WIN_LENGTH,
                      window=torch.from_numpy(window), center=True,
                      return_complex=True)[:, :N_FRAMES]
    mel = (spec.abs() ** 2).T.numpy() @ ta.mel_filterbank().astype(np.float64)
    logmel = np.log(np.maximum(mel, 1e-10))
    centred = ((logmel - logmel.mean()) / logmel.std()).T
    assert np.abs(centred - ref).max() > 100 * ATOL


def test_normalisation_is_global_zero_mean_unit_std():
    out = _torch_log_mel(_waveform(NEEDED, seed=4)).astype(np.float64)
    assert abs(out.mean()) < 1e-5 and abs(out.std() - 1) < 1e-4


def _wav_bytes(data, sr=16000, sampwidth=2, channels=1):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(sampwidth)
        w.setframerate(sr)
        w.writeframes(data.tobytes())
    return buf.getvalue()


def _pcm(n, sampwidth, channels, seed):
    rng = np.random.default_rng(seed)
    shape = (n * channels,)
    if sampwidth == 1:
        return rng.integers(0, 256, shape).astype(np.uint8)
    if sampwidth == 2:
        return rng.integers(-32768, 32768, shape).astype(np.int16)
    return rng.integers(-2 ** 31, 2 ** 31, shape).astype(np.int32)


@pytest.mark.parametrize("sampwidth, channels, sr", [
    (2, 1, 16000), (1, 1, 16000), (4, 1, 16000), (2, 2, 16000),
    (2, 1, 44100), (2, 2, 8000)])
def test_load_wav_equals_jax(tmp_path, sampwidth, channels, sr):
    data = _wav_bytes(_pcm(3001, sampwidth, channels, sampwidth + sr),
                      sr=sr, sampwidth=sampwidth, channels=channels)
    path = tmp_path / "clip.wav"
    path.write_bytes(data)
    for source in (data, str(path)):
        out = ta.load_wav(source)
        assert out.dtype == np.float32
        np.testing.assert_array_equal(out, ja.load_wav(source))


def test_load_wav_refuses_what_jax_refuses():
    data = _wav_bytes(np.zeros(10, np.int16))
    bad = data[:20] + b"\x03\x00" + data[22:]  # 3-byte samples claimed
    for module in (ta, ja):
        with pytest.raises(Exception):
            module.load_wav(b"RIFFxxxxWAVEjunk")
        with pytest.raises(Exception):
            module.load_wav(bad)


@pytest.mark.parametrize("n, length, overlap", [
    (16000 * 25, 10, 3), (16000 * 2, 1, 0), (16000 * 2 + 1, 1, 0),
    (100, 10, 3), (16000 * 7, 2.5, 0.5)])
def test_chunk_waveform_equals_jax(n, length, overlap):
    wav = _waveform(n, seed=n)
    out = ta.chunk_waveform(wav, length, overlap)
    ref = ja.chunk_waveform(wav, length, overlap)
    assert len(out) == len(ref) > 0
    for (s, e, piece), (rs, re_, rpiece) in zip(out, ref):
        assert (s, e) == (rs, re_)
        np.testing.assert_array_equal(piece, rpiece)
