"""The audio datasets and their pipeline steps.

Port of ``mscl_tpu/datasets/audio_dataset.py`` (reference mmaction
audio_dataset.py, audio_feature_dataset.py and the audio transforms of
pipelines/loading.py, augmentations.py and formating.py), numpy, bit for
bit:

- ``AudioDataset``: "path total_frames label..." lines over ``.wav``
  files; ``AudioFeatureDataset``: the same over ``.npy`` spectrogram
  features (the suffix is added where a path lacks it).
- ``LoadAudioFeature``: a feature map (T, F) from its ``.npy``;
  ``AudioDecodeInit``: a PCM wav through the stdlib's ``wave`` (8, 16 or
  32-bit, scaled by the dtype's max, channels averaged). A missing file
  gives zeros or, with ``pad_method='random'``, draws from the global
  ``np.random`` (a (640, 80) map; 10 s of samples), as JAX's does.
- ``AudioDecode`` / ``AudioFeatureSelector``: each sampled clip's span of
  the waveform or the map (the clip's first and last frame index over
  ``total_frames``, times ``length``), cut or zero-padded to
  ``fixed_length``.
- ``AudioAmplify``; ``MelSpectrogram`` (a numpy STFT with a Hann window of
  ``window_size`` ms, hop ``step_size`` ms, the power spectrum through a
  triangular mel filterbank, the log floored at 1e-10, cut or padded to
  ``fixed_length`` frames), and ``MelLogSpectrogram``, the name the raw
  audio config uses for it; ``FormatAudioShape('NCTF')``:
  (clips, T, F) -> (clips, 1, T, F).
"""
from __future__ import annotations

import os.path as osp
import wave

import numpy as np

from .base import BaseDataset
from .builder import DATASETS, PIPELINES


def _parse_audio_lines(ann_file, data_prefix, suffix, multi_class,
                       num_classes):
    video_infos = []
    with open(ann_file) as fin:
        for line in fin:
            parts = line.strip().split()
            if not parts:
                continue
            filename = parts[0]
            if data_prefix is not None:
                filename = osp.join(data_prefix, filename)
            if suffix and not filename.endswith(suffix):
                filename = filename + suffix
            total_frames = int(parts[1])
            labels = [int(x) for x in parts[2:]]
            assert labels, f'missing label in line: {line}'
            if multi_class:
                onehot = np.zeros(num_classes, np.float32)
                onehot[labels] = 1.0
                label = onehot
            else:
                assert len(labels) == 1
                label = labels[0]
            video_infos.append(dict(audio_path=filename,
                                    total_frames=total_frames,
                                    label=label))
    return video_infos


@DATASETS.register_module()
class AudioDataset(BaseDataset):

    def __init__(self, ann_file, pipeline, suffix='.wav', **kwargs):
        self.suffix = suffix
        super().__init__(ann_file, pipeline, modality='Audio', **kwargs)

    def load_annotations(self):
        return _parse_audio_lines(self.ann_file, self.data_prefix,
                                  self.suffix, self.multi_class,
                                  self.num_classes)


@DATASETS.register_module()
class AudioFeatureDataset(AudioDataset):

    def __init__(self, ann_file, pipeline, suffix='.npy', **kwargs):
        super().__init__(ann_file, pipeline, suffix=suffix, **kwargs)


@PIPELINES.register_module()
class LoadAudioFeature:

    def __init__(self, pad_method='zero'):
        assert pad_method in ('zero', 'random')
        self.pad_method = pad_method

    def __call__(self, results):
        if osp.exists(results['audio_path']):
            feature_map = np.load(results['audio_path'])
        elif self.pad_method == 'zero':
            feature_map = np.zeros((640, 80), np.float32)
        else:
            feature_map = np.random.rand(640, 80).astype(np.float32)
        results['length'] = feature_map.shape[0]
        results['audios'] = feature_map
        return results


@PIPELINES.register_module()
class AudioDecodeInit:

    def __init__(self, io_backend='disk', sample_rate=16000,
                 pad_method='zero', **kwargs):
        self.sample_rate = sample_rate
        assert pad_method in ('zero', 'random')
        self.pad_method = pad_method

    def __call__(self, results):
        if osp.exists(results['audio_path']):
            with wave.open(results['audio_path'], 'rb') as w:
                raw = w.readframes(w.getnframes())
                dtype = {1: np.int8, 2: np.int16, 4: np.int32}[
                    w.getsampwidth()]
                y = np.frombuffer(raw, dtype=dtype).astype(np.float32)
                y = y / float(np.iinfo(dtype).max)
                if w.getnchannels() > 1:
                    y = y.reshape(-1, w.getnchannels()).mean(axis=1)
        elif self.pad_method == 'zero':
            y = np.zeros(10 * self.sample_rate, np.float32)
        else:
            y = np.random.rand(10 * self.sample_rate).astype(np.float32)
        results['audios'] = y
        results['length'] = y.shape[0]
        results['sample_rate'] = self.sample_rate
        return results


def _clip_spans(results):
    """(start, end) of each sampled clip in ``length`` units."""
    frame_inds = results['frame_inds'].reshape(results['num_clips'], -1)
    total, length = results['total_frames'], results['length']
    for inds in frame_inds:
        start = max(0, int(round((inds[0] + 1) / total * length)))
        end = min(length, int(round((inds[-1] + 1) / total * length)))
        yield start, end


@PIPELINES.register_module()
class AudioDecode:

    def __init__(self, fixed_length=32000):
        self.fixed_length = fixed_length

    def __call__(self, results):
        audio, clips = results['audios'], []
        for start, end in _clip_spans(results):
            clip = audio[start:end]
            if clip.shape[0] >= self.fixed_length:
                clip = clip[:self.fixed_length]
            else:
                clip = np.pad(clip, (0, self.fixed_length - clip.shape[0]))
            clips.append(clip)
        results['audios'] = np.asarray(clips, np.float32)
        results['audios_shape'] = results['audios'].shape
        return results


@PIPELINES.register_module()
class AudioFeatureSelector:

    def __init__(self, fixed_length=128):
        self.fixed_length = fixed_length

    def __call__(self, results):
        audio, clips = results['audios'], []
        for start, end in _clip_spans(results):
            clip = audio[start:end, :]
            if clip.shape[0] >= self.fixed_length:
                clip = clip[:self.fixed_length, :]
            else:
                clip = np.pad(clip, ((0, self.fixed_length - clip.shape[0]),
                                     (0, 0)))
            clips.append(clip)
        results['audios'] = np.asarray(clips, np.float32)
        results['audios_shape'] = results['audios'].shape
        return results


@PIPELINES.register_module()
class AudioAmplify:

    def __init__(self, ratio):
        assert isinstance(ratio, float)
        self.ratio = ratio

    def __call__(self, results):
        results['audios'] = (results['audios'] * self.ratio).astype(
            np.float32)
        results['amplify_ratio'] = self.ratio
        return results


def _mel_filterbank(sr, n_fft, n_mels, fmin=0.0, fmax=None):
    """Triangular mel filters (n_mels, n_fft // 2 + 1) on the HTK scale,
    their corners rounded down to FFT bins."""
    fmax = fmax or sr / 2

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    bins = np.floor((n_fft + 1) * mel_to_hz(mels) / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for i in range(n_mels):
        lo, ctr, hi = bins[i], bins[i + 1], bins[i + 2]
        for j in range(lo, ctr):
            fb[i, j] = (j - lo) / (ctr - lo)
        for j in range(ctr, hi):
            fb[i, j] = (hi - j) / (hi - ctr)
    return fb


@PIPELINES.register_module()
class MelSpectrogram:

    def __init__(self, window_size=32, step_size=16, n_mels=80,
                 fixed_length=128):
        self.window_size = window_size
        self.step_size = step_size
        self.n_mels = n_mels
        self.fixed_length = fixed_length

    def __call__(self, results):
        sr = results['sample_rate']
        n_fft = int(round(sr * self.window_size / 1000.0))
        hop = int(round(sr * self.step_size / 1000.0))
        fb = _mel_filterbank(sr, n_fft, self.n_mels)
        window = np.hanning(n_fft).astype(np.float32)
        out = []
        for y in np.atleast_2d(results['audios']):
            n_frames = max(1, 1 + (len(y) - n_fft) // hop)
            frames = np.stack([y[i * hop:i * hop + n_fft] * window
                               for i in range(n_frames)])
            spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2
            mel = np.log(np.maximum(spec @ fb.T, 1e-10))
            if mel.shape[0] >= self.fixed_length:
                mel = mel[:self.fixed_length]
            else:
                mel = np.pad(mel, ((0, self.fixed_length - mel.shape[0]),
                                   (0, 0)))
            out.append(mel)
        results['audios'] = np.asarray(out, np.float32)
        results['audios_shape'] = results['audios'].shape
        return results


@PIPELINES.register_module()
class MelLogSpectrogram(MelSpectrogram):
    """The raw audio config's name for the log-mel transform (the
    reference ships no pipeline of that name; the JAX package's
    ``MelSpectrogram`` already takes the log)."""


@PIPELINES.register_module()
class FormatAudioShape:

    def __init__(self, input_format='NCTF'):
        assert input_format == 'NCTF'
        self.input_format = input_format

    def __call__(self, results):
        clip, sample_len, freq = results['audios'].shape
        results['audios'] = results['audios'].reshape(clip, 1, sample_len,
                                                       freq)
        results['input_shape'] = results['audios'].shape
        return results
