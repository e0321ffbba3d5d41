"""Audio preprocessing: WAV decode (host) + log-mel spectrogram (device), in
PyTorch (port of marqo_tpu/ops/audio_ops.py).

Role parity: the reference's audio path decodes/chunks via ffmpeg and
preprocesses inside LanguageBind's torch transforms
(s2_inference/languagebind/, streaming_media_processor.py). Here WAV
decode is stdlib (no ffmpeg needed for .wav); ``load_wav``,
``mel_filterbank`` and ``chunk_waveform`` are the JAX package's numpy
functions, copied as they are. The STFT → mel → log chain runs in torch on
the waveform's device, with the JAX version's arithmetic:

  - the waveform is TILED to the needed length (``jnp.resize`` repeats it;
    it does not zero-pad);
  - frames are taken by index, hop 160 and window 400, with no centring and
    no padding (so no ``torch.stft``, which centres and pads);
  - the window is the SYMMETRIC Hann window of ``jnp.hanning``
    (``torch.hann_window(periodic=False)``);
  - the log-mel is normalised by its global mean and (population) standard
    deviation.
"""

import io
import wave
from typing import Union

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 512
WIN_LENGTH = 400  # 25 ms
HOP_LENGTH = 160  # 10 ms
N_MELS = 128


def load_wav(source: Union[str, bytes], target_sr: int = SAMPLE_RATE
             ) -> np.ndarray:
    """Decode a WAV file/bytes → mono float32 at target_sr (linear resample).
    """
    fh = io.BytesIO(source) if isinstance(source, bytes) else source
    with wave.open(fh, "rb") as w:
        sr = w.getframerate()
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128) / 128.0
    else:
        raise ValueError(f"Unsupported WAV sample width {sampwidth}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    if sr != target_sr:
        n_out = int(round(len(data) * target_sr / sr))
        x_old = np.linspace(0, 1, len(data), endpoint=False)
        x_new = np.linspace(0, 1, n_out, endpoint=False)
        data = np.interp(x_new, x_old, data).astype(np.float32)
    return data


def _hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)


def _mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)


def mel_filterbank(n_mels: int = N_MELS, n_fft: int = N_FFT,
                   sr: int = SAMPLE_RATE) -> np.ndarray:
    """(n_fft//2+1, n_mels) triangular mel filter matrix (Slaney-style)."""
    fmin, fmax = 0.0, sr / 2
    mels = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz = _mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * hz / sr).astype(int)
    fb = np.zeros((n_fft // 2 + 1, n_mels), dtype=np.float32)
    for m in range(n_mels):
        left, center, right = bins[m], bins[m + 1], bins[m + 2]
        for k in range(left, center):
            if center > left:
                fb[k, m] = (k - left) / (center - left)
        for k in range(center, right):
            if right > center:
                fb[k, m] = (right - k) / (right - center)
    return fb


def tile_to_length(waveform: torch.Tensor, length: int) -> torch.Tensor:
    """``waveform`` repeated end to end and cut to ``length`` samples, as
    ``jnp.resize`` does (an empty waveform gives zeros, as numpy's)."""
    if waveform.numel() == 0:
        return waveform.new_zeros(length)
    repeats = -(-length // waveform.numel())
    return waveform.repeat(repeats)[:length]


def log_mel_spectrogram(waveform: torch.Tensor, mel_fb: torch.Tensor,
                        n_frames: int) -> torch.Tensor:
    """waveform (n_samples,) fp32 → (n_mels, n_frames) log-mel on the
    waveform's device; ``mel_fb`` (n_fft//2+1, n_mels) on the same device.

    ``n_frames`` is fixed by the caller (callers pad/truncate audio to a
    fixed clip length — the chunker guarantees it)."""
    needed = (n_frames - 1) * HOP_LENGTH + WIN_LENGTH
    wav = tile_to_length(waveform.reshape(-1), needed)
    device = wav.device
    idx = (torch.arange(n_frames, device=device)[:, None] * HOP_LENGTH +
           torch.arange(WIN_LENGTH, device=device)[None, :])
    frames = wav[idx]  # (n_frames, win)
    window = torch.hann_window(WIN_LENGTH, periodic=False, dtype=frames.dtype,
                               device=device)
    spec = torch.fft.rfft(frames * window, n=N_FFT, dim=-1)
    power = spec.abs() ** 2  # (n_frames, n_fft//2+1)
    mel = power @ mel_fb.to(power.dtype)  # (n_frames, n_mels)
    logmel = torch.log(torch.clamp(mel, min=1e-10))
    # normalize roughly to zero-mean unit-var (CLAP-style)
    logmel = (logmel - logmel.mean()) / torch.clamp(
        logmel.std(correction=0), min=1e-5)
    return logmel.T  # (n_mels, n_frames)


def chunk_waveform(waveform: np.ndarray, split_length_s: float = 10.0,
                   split_overlap_s: float = 3.0,
                   sr: int = SAMPLE_RATE):
    """Fixed-length overlapping audio chunks (reference audio
    preprocessing defaults: splitLength 10 / overlap 3,
    index_settings.py audioPreprocessing)."""
    chunk = int(split_length_s * sr)
    step = max(1, chunk - int(split_overlap_s * sr))
    out = []
    start = 0
    n = len(waveform)
    while start < n:
        piece = waveform[start:start + chunk]
        if len(piece) < chunk:
            piece = np.pad(piece, (0, chunk - len(piece)))
        out.append((start / sr, min((start + chunk) / sr, n / sr), piece))
        if start + chunk >= n:
            break
        start += step
    return out
