"""Batched log-mel spectrogram frontend, GEMM-native (port of
mm_distillnet_tpu/ops/audio.py).

The reference computes librosa 0.7.2's melspectrogram(sr=44100,
n_fft=1024, hop_length=256, n_mels=80) and power_to_db(ref=np.max) file by
file (reference mp3_to_pkl.py:30-42). STFT defaults there: periodic Hann
window, center=True with reflect padding, power 2; the mel filterbank is
slaney-scale with area normalisation, fmin 0, fmax sr/2.

The rFFT becomes two matmuls with windowed cos / sin matrices, so the
frontend is framing + three fp32 GEMMs + elementwise work:

    frames (B, F, n_fft) @ dft_cos (n_fft, n_bins) -> real
    frames (B, F, n_fft) @ dft_sin (n_fft, n_bins) -> imag
    power = real^2 + imag^2
    mel   = mel_fb (n_mels, n_bins) @ power (B, n_bins, F)

The matrices are built with numpy exactly as the JAX package builds them.
The GEMMs must stay true fp32: under TF32 the dB values would move by
about 1e-3 relative, so nothing here changes torch's matmul precision.
"""
from __future__ import annotations

import functools
import shutil
import subprocess
import wave
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SR = 44100
N_FFT = 1024
HOP = 256
N_MELS = 80


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann (scipy.signal.get_window('hann', n, fftbins=True))."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep,
                    mels)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    freqs)


def mel_filterbank(sr: int = SR, n_fft: int = N_FFT, n_mels: int = N_MELS,
                   fmin: float = 0.0, fmax: Optional[float] = None
                   ) -> np.ndarray:
    """Slaney-scale mel filterbank with area norm, (n_mels, 1 + n_fft//2),
    as librosa.filters.mel(htk=False, norm=1)."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0, sr / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                          n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    weights = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def dft_matrices(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT matrices (n_fft, n_bins): frames @ cos,
    frames @ sin."""
    n_bins = 1 + n_fft // 2
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    w = hann_window(n_fft)[:, None]
    return ((np.cos(ang) * w).astype(np.float32),
            (-np.sin(ang) * w).astype(np.float32))


@functools.lru_cache(maxsize=8)
def _on_device(kind: str, device: torch.device, *args) -> torch.Tensor:
    if kind == 'dft':
        cos_m, sin_m = dft_matrices(*args)
        return torch.stack([torch.from_numpy(cos_m),
                            torch.from_numpy(sin_m)]).to(device)
    return torch.from_numpy(mel_filterbank(*args)).to(device)


def frame_signal(y: torch.Tensor, n_fft: int = N_FFT, hop: int = HOP,
                 center: bool = True) -> torch.Tensor:
    """(B, T) PCM -> (B, num_frames, n_fft) frames; center=True
    reflect-pads n_fft//2 on both sides (librosa 0.7.2's stft)."""
    if center:
        # torch's reflect padding takes a (B, C, T) input
        y = F.pad(y[:, None], (n_fft // 2, n_fft // 2), mode='reflect')[:, 0]
    return y.unfold(-1, n_fft, hop)


def power_spectrogram(y: torch.Tensor, n_fft: int = N_FFT, hop: int = HOP,
                      center: bool = True) -> torch.Tensor:
    """(B, T) -> (B, n_bins, num_frames) power spectrogram |STFT|^2."""
    frames = frame_signal(y.float(), n_fft, hop, center)
    dft = _on_device('dft', frames.device, n_fft)
    re = torch.matmul(frames, dft[0])
    im = torch.matmul(frames, dft[1])
    return (re * re + im * im).transpose(1, 2)


def melspectrogram(y: torch.Tensor, sr: int = SR, n_fft: int = N_FFT,
                   hop: int = HOP, n_mels: int = N_MELS) -> torch.Tensor:
    """(B, T) PCM -> (B, n_mels, num_frames) mel power spectrogram, the
    layout of librosa.feature.melspectrogram."""
    power = power_spectrogram(y, n_fft, hop)
    fb = _on_device('mel', power.device, sr, n_fft, n_mels)
    return torch.matmul(fb, power)


def power_to_db(S: torch.Tensor, top_db: float = 80.0,
                amin: float = 1e-10) -> torch.Tensor:
    """librosa.power_to_db(S, ref=np.max) per clip: 10 log10(max(S, amin))
    - 10 log10(max(ref, amin)), clipped at (peak - top_db). The reference
    max is taken over each clip (all but the leading axis), over the
    zero-padded row of a batch as the JAX package takes it."""
    S = S.float()
    dims = tuple(range(1, S.ndim))
    ref = S.amax(dim=dims, keepdim=True)
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref, min=amin))
    peak = log_spec.amax(dim=dims, keepdim=True)
    return torch.maximum(log_spec, peak - top_db)


def log_mel_batch(pcm: torch.Tensor, sr: int = SR, n_fft: int = N_FFT,
                  hop: int = HOP, n_mels: int = N_MELS) -> torch.Tensor:
    """(B, M, T) multi-mic PCM -> (B, n_mels, frames, M) log-mel stack, the
    shape chain of the multimodal dataset (8 mel spectrograms stacked and
    transposed to (80, T, 8)); power_to_db normalises each (clip, mic)
    like the reference's per-file pickles."""
    b, m, t = pcm.shape
    db = power_to_db(melspectrogram(pcm.reshape(b * m, t), sr, n_fft, hop,
                                    n_mels))
    return db.reshape(b, m, n_mels, -1).permute(0, 2, 3, 1)


def decode_audio(path: str, sr: int = SR) -> np.ndarray:
    """Decode mp3 / wav to mono float32 PCM at `sr` (librosa.load's
    semantics: mono mix-down, floats in [-1, 1])."""
    if path.endswith('.wav'):
        with wave.open(path, 'rb') as w:
            n = w.getnframes()
            raw = w.readframes(n)
            width = w.getsampwidth()
            channels = w.getnchannels()
            rate = w.getframerate()
        dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
        pcm = np.frombuffer(raw, dtype=dtype).astype(np.float32)
        if width == 1:
            pcm = (pcm - 128.0) / 128.0
        else:
            pcm = pcm / float(np.iinfo(dtype).max)
        if channels > 1:
            pcm = pcm.reshape(-1, channels).mean(axis=1)
        if rate != sr:
            x = np.arange(len(pcm)) / rate
            xi = np.arange(int(len(pcm) * sr / rate)) / sr
            pcm = np.interp(xi, x, pcm).astype(np.float32)
        return pcm
    if shutil.which('ffmpeg') is None:
        raise RuntimeError(
            f'cannot decode {path}: ffmpeg not available (wav is supported '
            'natively)')
    out = subprocess.run(
        ['ffmpeg', '-v', 'quiet', '-i', path, '-f', 'f32le', '-ac', '1',
         '-ar', str(sr), 'pipe:1'],
        check=True, stdout=subprocess.PIPE)
    return np.frombuffer(out.stdout, dtype=np.float32)
