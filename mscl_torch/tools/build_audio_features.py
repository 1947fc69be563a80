"""Precompute log-mel features from wav files for ``AudioFeatureDataset``.

Port of ``tools/data/build_audio_features.py``: every ``*.wav`` under
AUDIO_ROOT (recursively) through ``AudioDecodeInit`` and
``MelSpectrogram`` (``--n-mels``, ``--fixed-length`` frames, 640 = 10 s at
the defaults) into OUT_ROOT/<name>.npy, float32; a file already there is
kept. ``--num-workers`` above 1 maps a module-level function over forked
workers. The ``.npy`` files equal the JAX tool's byte for byte.

    python -m mscl_torch.tools.build_audio_features AUDIO_ROOT OUT_ROOT \\
        [--n-mels 80] [--fixed-length 640] [--num-workers 4]
"""
from __future__ import annotations

import argparse
import glob
import multiprocessing as mp
import os
import os.path as osp
from typing import Optional, Sequence

import numpy as np

from ..datasets.audio_dataset import AudioDecodeInit, MelSpectrogram


def build_one(args) -> None:
    wav, out_root, n_mels, fixed_length = args
    out = osp.join(out_root, osp.splitext(osp.basename(wav))[0] + '.npy')
    if osp.exists(out):
        return
    results = AudioDecodeInit()(dict(audio_path=wav))
    results['audios'] = results['audios'][None]
    mel = MelSpectrogram(n_mels=n_mels, fixed_length=fixed_length)(
        results)['audios'][0]
    np.save(out, mel.astype(np.float32))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('audio_root')
    p.add_argument('out_root')
    p.add_argument('--n-mels', type=int, default=80)
    p.add_argument('--fixed-length', type=int, default=640,
                   help='mel frames kept per clip (10 s at defaults)')
    p.add_argument('--num-workers', type=int, default=4)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Returns the number of wavs found."""
    args = parse_args(argv)
    os.makedirs(args.out_root, exist_ok=True)
    wavs = sorted(glob.glob(osp.join(args.audio_root, '**', '*.wav'),
                            recursive=True))
    jobs = [(w, args.out_root, args.n_mels, args.fixed_length)
            for w in wavs]
    if args.num_workers > 1:
        with mp.get_context('fork').Pool(args.num_workers) as pool:
            pool.map(build_one, jobs)
    else:
        for job in jobs:
            build_one(job)
    print(f'{len(wavs)} wavs -> {args.out_root}')
    return len(wavs)


if __name__ == '__main__':
    main()
