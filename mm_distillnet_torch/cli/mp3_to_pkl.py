"""Offline audio preprocessing: mp3 / wav -> log-mel spectrogram pickles
(port of the root mp3_to_pkl.py; reference mp3_to_pkl.py:18-42):

    python -m mm_distillnet_torch.cli.mp3_to_pkl --dir <drive-or-dataset-path> \\
        [--batch_size N] [--device cuda|cpu]

Decoding stays on the host (`ops/audio.py` `decode_audio`: the stdlib
`wave` for .wav, an ffmpeg subprocess for .mp3); the STFT, mel and dB math
runs batched on the device through ops/audio.py. One (80, 1 + n // 256) float32 dB pickle per file,
beside it, drop-in for the reference's.
"""
from __future__ import annotations

import argparse
import glob
import os
import pickle

import numpy as np
import torch

from ..device import resolve_device
from ..ops.audio import HOP, decode_audio, melspectrogram, power_to_db


def process_files(files, batch_size: int = 16, device='cuda'):
    """Write `<file>.pkl` beside each file; returns the pickles' paths.
    Each batch is zero-padded to its longest clip, as in the JAX package,
    so power_to_db's reference max is taken over the padded row."""
    dev = resolve_device(device)
    written = []
    for start in range(0, len(files), batch_size):
        chunk = files[start:start + batch_size]
        pcms = [decode_audio(f) for f in chunk]
        batch = np.zeros((len(pcms), max(len(p) for p in pcms)), np.float32)
        for i, p in enumerate(pcms):
            batch[i, :len(p)] = p
        db = power_to_db(melspectrogram(torch.from_numpy(batch).to(dev)))
        db = db.cpu().numpy()
        for i, f in enumerate(chunk):
            out_path = os.path.splitext(f)[0] + '.pkl'
            with open(out_path, 'wb') as handle:
                pickle.dump(db[i, :, :1 + len(pcms[i]) // HOP]
                            .astype(np.float32), handle,
                            protocol=pickle.HIGHEST_PROTOCOL)
            print(out_path)
            written.append(out_path)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(description='Get the audio inputs')
    parser.add_argument('--dir', required=True,
                        help='The drive directory or the dataset path')
    parser.add_argument('--batch_size', type=int, default=16)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    pattern = 'audio/*' if 'drive' in args.dir else '*/audio/*'
    files = sorted(
        glob.glob(os.path.join(args.dir, pattern + 'mp3')) +
        glob.glob(os.path.join(args.dir, pattern + 'wav')))
    if not files:
        print(f'no audio files under {args.dir}')
        return []
    return process_files(files, args.batch_size, args.device)


if __name__ == '__main__':
    main()
