"""The port's log-mel frontend (ops/audio.py) and its mp3_to_pkl CLI
against the reference's: the filterbank and DFT matrices bit-equal, the
framing exact, the mel power within rtol 1e-4 and the dB values within
1e-3 dB on seeded PCM of odd lengths zero-padded into one batch (measured:
5.5e-6 relative and 2.7e-5 dB), and the CLI's pickles against the root
mp3_to_pkl.py's on the same seeded .wav files."""
import importlib.util
import os
import pickle
import shutil
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_distillnet_tpu.ops import audio as jax_audio
from mm_distillnet_torch.cli import mp3_to_pkl
from mm_distillnet_torch.ops import audio

from .test_audio_frontend import _np_stft_power
from .test_torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENGTHS = (44100 + 37, 30001, 51211)   # odd lengths, padded into a batch
DB_ATOL = 1e-3
MEL_RTOL = 1e-4


def _pcm_batch(seed=0):
    rng = np.random.default_rng(seed)
    batch = np.zeros((len(LENGTHS), max(LENGTHS)), np.float32)
    for i, n in enumerate(LENGTHS):
        t = np.arange(n)
        batch[i, :n] = (0.3 * rng.standard_normal(n) * np.sin(t / 500.0)
                        + 0.2 * np.sin(2 * np.pi * 440.0 * t / audio.SR))
    return batch


def test_matrices_are_bit_equal_to_the_reference():
    np.testing.assert_array_equal(audio.hann_window(1024),
                                  jax_audio.hann_window(1024))
    fb = audio.mel_filterbank()
    assert fb.shape == (80, 513) and fb.dtype == np.float32
    np.testing.assert_array_equal(fb, jax_audio.mel_filterbank())
    np.testing.assert_array_equal(audio.mel_filterbank(22050, 512, 40),
                                  jax_audio.mel_filterbank(22050, 512, 40))
    for got, want in zip(audio.dft_matrices(1024),
                         jax_audio._dft_matrices(1024)):
        np.testing.assert_array_equal(got, want)


def test_framing_and_power_spectrogram():
    """frame_signal is exact (reflect padding of a 2-D batch); the power
    spectrogram meets the reference test's numpy rFFT oracle (rtol = atol
    = 2e-3, tests/test_audio_frontend.py)."""
    batch = _pcm_batch()
    frames = audio.frame_signal(torch.from_numpy(batch))
    assert tuple(frames.shape) == (3, 1 + batch.shape[1] // 256, 1024)
    np.testing.assert_array_equal(
        frames.numpy(), np.asarray(jax_audio.frame_signal(
            jnp.asarray(batch))))
    y = np.random.default_rng(0).normal(size=8192).astype(np.float32)
    got = audio.power_spectrogram(torch.from_numpy(y[None]))[0].numpy()
    oracle = _np_stft_power(y)
    assert got.shape == oracle.shape
    np.testing.assert_allclose(got, oracle, rtol=2e-3, atol=2e-3)


def test_melspectrogram_and_power_to_db_match_the_reference():
    batch = _pcm_batch()
    want_mel = np.asarray(jax_audio.melspectrogram(jnp.asarray(batch)))
    want_db = np.asarray(jax_audio.power_to_db(jnp.asarray(want_mel)))
    mel = audio.melspectrogram(torch.from_numpy(batch))
    db = audio.power_to_db(mel)
    assert mel.dtype == db.dtype == torch.float32
    assert tuple(mel.shape) == want_mel.shape == (3, 80, 201)
    np.testing.assert_allclose(mel.numpy(), want_mel, rtol=MEL_RTOL, atol=0)
    np.testing.assert_allclose(db.numpy(), want_db, rtol=0, atol=DB_ATOL)
    # ref=max per clip over the padded row: each clip peaks at 0 dB and
    # is clipped 80 dB below
    peaks = db.amax(dim=(1, 2))
    np.testing.assert_allclose(peaks.numpy(), 0.0, atol=1e-5)
    assert float((db.amin(dim=(1, 2)) - peaks).min()) >= -80.0 - 1e-4
    # the same power through power_to_db alone
    np.testing.assert_allclose(
        audio.power_to_db(torch.from_numpy(want_mel.copy())).numpy(),
        want_db, rtol=0, atol=DB_ATOL)


def test_log_mel_batch_matches_the_reference():
    rng = np.random.default_rng(3)
    pcm = rng.normal(size=(2, 8, 22016 + 13)).astype(np.float32)
    want = np.asarray(jax_audio.log_mel_batch(jnp.asarray(pcm)))
    got = audio.log_mel_batch(torch.from_numpy(pcm)).numpy()
    assert got.shape == want.shape == (2, 80, 1 + 22029 // 256, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=DB_ATOL)
    np.testing.assert_allclose(got.max(axis=(1, 2)), 0.0, atol=1e-4)


def _write_wav(path, pcm, rate=audio.SR, width=2, channels=1):
    scale = {1: 127.0, 2: 32767.0, 4: 2147483647.0}[width]
    data = np.clip(pcm, -1, 1) * scale
    if width == 1:
        data = (data + 128).astype(np.uint8)
    else:
        data = data.astype({2: np.int16, 4: np.int32}[width])
    with wave.open(str(path), 'wb') as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(data.tobytes())


def _import_root_cli():
    """The root mp3_to_pkl.py, imported by path (a bare import depends on
    sys.path and test order)."""
    spec = importlib.util.spec_from_file_location(
        'mmdt_mp3_to_pkl_cli', os.path.join(REPO, 'mp3_to_pkl.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mp3_to_pkl_main_matches_the_jax_cli(tmp_path, capsys):
    """Seeded .wav files in the dataset layout (*/audio/*.wav), in two
    copies of one directory: the port's main (--device cpu, batch 2, so
    two batches with padding) and the root CLI's write pickles of the
    same (80, 1 + n // 256) shape and dB values within 1e-3."""
    batch = _pcm_batch(7)
    src = tmp_path / 'ds'
    for i, n in enumerate(LENGTHS):
        drive = src / f'drive_{i % 2}' / 'audio'
        drive.mkdir(parents=True, exist_ok=True)
        _write_wav(drive / f'{i:03d}.wav', batch[i, :n])
    ours, ref = tmp_path / 'ours', tmp_path / 'ref'
    shutil.copytree(src, ours)
    shutil.copytree(src, ref)
    written = mp3_to_pkl.main(['--dir', str(ours), '--batch_size', '2',
                               '--device', 'cpu'])
    _import_root_cli().main(['--dir', str(ref), '--batch_size', '2'])
    assert len(written) == len(LENGTHS)
    for path in written:
        rel = os.path.relpath(path, ours)
        with open(path, 'rb') as f:
            got = pickle.load(f)
        with open(os.path.join(ref, rel), 'rb') as f:
            want = pickle.load(f)
        n = len(mp3_to_pkl.decode_audio(path[:-4] + '.wav'))
        assert got.dtype == np.float32 and got.shape == (80, 1 + n // 256)
        assert want.shape == got.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=DB_ATOL)
    assert capsys.readouterr().out.count('.pkl') == 2 * len(LENGTHS)
    assert mp3_to_pkl.main(['--dir', str(tmp_path / 'empty'),
                            '--device', 'cpu']) == []


@pytest.mark.parametrize('width,channels,rate', [(1, 1, audio.SR),
                                                 (2, 2, audio.SR),
                                                 (4, 1, 22050)])
def test_decode_audio_matches_the_jax_cli(tmp_path, width, channels, rate):
    """8-, 16- and 32-bit PCM, a stereo mix-down and a resample."""
    pcm = np.sin(np.arange(5000 * channels) / 37.0).astype(np.float32) * 0.5
    path = tmp_path / 'clip.wav'
    _write_wav(path, pcm, rate, width, channels)
    got = mp3_to_pkl.decode_audio(str(path))
    want = _import_root_cli().decode_audio(str(path))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_mp3_to_pkl_raises_without_a_card_or_ffmpeg(tmp_path):
    (tmp_path / 'x' / 'audio').mkdir(parents=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            mp3_to_pkl.main(['--dir', str(tmp_path)])
    if shutil.which('ffmpeg') is None:
        mp3 = tmp_path / 'x' / 'audio' / 'a.mp3'
        mp3.write_bytes(b'\0' * 16)
        with pytest.raises(RuntimeError, match='ffmpeg'):
            mp3_to_pkl.decode_audio(str(mp3))
