"""Synthetic AVA and audio data for the port's tests, made from a seed.

- ``write_ava_set``: an AVA-style set: ``ava.csv`` (video_id, timestamp,
  x1, y1, x2, y2 normalized, action id, person id), a proposal pickle
  ({'vid,ts': (n, 5) normalized boxes with a detector score}: jittered
  copies of the gts, which the assigner takes as positives at IoU 0.9,
  boxes clear of them, and boxes under the score threshold), an exclude
  csv naming one keyframe, and ``vid/img_{:05}.jpg`` rawframes (written
  by the caller's ``imwrite(path, hwc_uint8)``) around each keyframe.
- ``write_wavs`` / ``write_features``: 16-bit PCM wavs (the stdlib's
  ``wave``) or (T, 80) float32 ``.npy`` features, with the
  "path total_frames label" list beside them.

Pure numpy and the stdlib; chip_smoke.py writes the same shapes with the
port's own JPEG encoder.
"""
import os
import os.path as osp
import pickle
import wave

import numpy as np

FPS = 30
START = 900


def _box(rng, lo=0.05, hi=0.95, min_size=0.2):
    x1, y1 = rng.uniform(lo, hi - min_size, 2)
    x2 = rng.uniform(x1 + min_size, hi)
    y2 = rng.uniform(y1 + min_size, hi)
    return np.array([x1, y1, x2, y2])


def _jitter(box, rng, amount=0.004):
    return np.clip(box + rng.uniform(-amount, amount, 4), 0.0, 1.0)


def _frame(rng, hw, i):
    img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    if i % 2:
        img = (np.cumsum(img, axis=1) // 41 % 256).astype(np.uint8)
    return img


def write_ava_set(root, imwrite, n_videos=2, keyframes=(902, 903),
                  hw=(48, 64), labels=(1, 2, 3, 5, 11, 12, 14, 80),
                  span=48, seed=0, distinct=None):
    """Returns dict(ann, proposals, exclude, prefix, keys): the files
    written under ``root`` and the keyframe keys ('vid,ts') in the csv's
    order. Each keyframe holds 1-3 persons with 1-3 actions each from
    ``labels``; the exclude file names the last keyframe of the last
    video; frames run from the first keyframe's centre minus ``span`` to
    the last one's plus ``span`` (every clip of the shipped configs lies
    inside, jitter included). Every frame is drawn anew, or with
    ``distinct`` frame i is the (i % distinct)-th of that many drawn once
    (the same array object each time, which a caching ``imwrite`` can
    encode once)."""
    rng = np.random.default_rng(seed)
    pool = [_frame(rng, hw, i) for i in range(distinct or 0)]
    prefix = osp.join(root, 'rawframes')
    rows, props, keys = [], {}, []
    for v in range(n_videos):
        vid = f'vid{v:02d}'
        vdir = osp.join(prefix, vid)
        os.makedirs(vdir, exist_ok=True)
        centres = [FPS * (ts - START) + 1 for ts in keyframes]
        first = max(1, centres[0] - span)
        for i in range(first, centres[-1] + span + 1):
            img = pool[(i + 5 * v) % distinct] if distinct else \
                _frame(rng, hw, i)
            imwrite(osp.join(vdir, f'img_{i:05}.jpg'), img)
        for ts in keyframes:
            key = f'{vid},{ts:04d}'
            keys.append(key)
            boxes = [_box(rng) for _ in range(1 + rng.integers(0, 3))]
            for p, box in enumerate(boxes):
                acts = rng.choice(labels, 1 + rng.integers(0, 3),
                                  replace=False)
                for a in sorted(acts):
                    rows.append(f'{vid},{ts:04d},' + ','.join(
                        f'{c:.3f}' for c in box) + f',{a},{p}')
            det = [np.append(_jitter(b, rng), rng.uniform(0.92, 1.0))
                   for b in boxes]
            det += [np.append(_box(rng), rng.uniform(0.9, 1.0))
                    for _ in range(2)]
            det += [np.append(_box(rng), rng.uniform(0.1, 0.8))
                    for _ in range(2)]
            props[key] = np.array(det, np.float32)
    ann = osp.join(root, 'ava.csv')
    with open(ann, 'w') as f:
        f.write('\n'.join(rows) + '\n')
    proposals = osp.join(root, 'proposals.pkl')
    with open(proposals, 'wb') as f:
        pickle.dump(props, f)
    exclude = osp.join(root, 'exclude.csv')
    with open(exclude, 'w') as f:
        f.write(f'vid{n_videos - 1:02d},{keyframes[-1]:04d}\n')
    return dict(ann=ann, proposals=proposals, exclude=exclude,
                prefix=prefix, keys=keys)


def write_wavs(root, n=4, seconds=2.0, sr=16000, seed=0, channels=1):
    """``clip_{i}.wav`` int16 PCM (noise and a tone) and ``wav.txt``
    ("clip_{i}.wav total_frames label" lines, 30 frames a second)."""
    rng = np.random.default_rng(seed)
    lines = []
    t = np.arange(int(seconds * sr)) / sr
    for i in range(n):
        y = rng.normal(size=(t.size, channels)) * 2000 + \
            8000 * np.sin(2 * np.pi * (220 + 110 * i) * t)[:, None]
        with wave.open(osp.join(root, f'clip_{i}.wav'), 'wb') as w:
            w.setnchannels(channels)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes(y.astype(np.int16).tobytes())
        lines.append(f'clip_{i}.wav {int(seconds * FPS)} {i % 3}')
    ann = osp.join(root, 'wav.txt')
    with open(ann, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return ann


def write_features(root, n=4, frames=(40, 24, 33, 64), n_mels=80, seed=0):
    """``feat_{i}.npy`` log-mel-like (T_i, n_mels) float32 features and
    ``feat.txt`` ("feat_{i} total_frames label" lines, the suffix left to
    the dataset)."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        t = frames[i % len(frames)]
        np.save(osp.join(root, f'feat_{i}.npy'),
                rng.normal(-4.0, 2.0, (t, n_mels)).astype(np.float32))
        lines.append(f'feat_{i} {t * 2} {i % 3}')
    ann = osp.join(root, 'feat.txt')
    with open(ann, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return ann
