"""Synthetic localization data for the port's tests, made from a seed:
ActivityNet-style features and annotations (BMN, BSN), a THUMOS-style
rawframe set with its SSN proposal list, and HVU tag annotations over a
rawframe set. Pure numpy and the caller's ``imwrite`` for the frames."""
import json
import os
import os.path as osp

import numpy as np


def write_activitynet(root, n_videos=4, t_raw=20, feat_dim=24, seed=0):
    """``anno.json`` ({v_name: duration_second, duration_frame,
    feature_frame, annotations [{segment, label}]}, 1-3 segments a video)
    and ``features/v_name.npy`` of ``t_raw + v`` rows each; returns (the
    json's path, the features' directory)."""
    rng = np.random.default_rng(seed)
    feat_dir = osp.join(root, 'features')
    os.makedirs(feat_dir, exist_ok=True)
    anno = {}
    for v in range(n_videos):
        name = f'v_video{v:03d}'
        duration = float(np.round(rng.uniform(30, 90), 2))
        frames = int(duration * 30)
        cuts = np.sort(rng.uniform(0, duration, 2 * (1 + v % 3)))
        anno[name] = dict(
            duration_second=duration, duration_frame=frames,
            feature_frame=frames // 16 * 16,
            annotations=[dict(segment=[float(np.round(cuts[2 * k], 2)),
                                       float(np.round(cuts[2 * k + 1], 2))],
                              label=f'class{(v + k) % 3}')
                         for k in range(1 + v % 3)])
        np.save(osp.join(feat_dir, name + '.npy'),
                rng.normal(size=(t_raw + v, feat_dim)).astype(np.float32))
    ann = osp.join(root, 'anno.json')
    with open(ann, 'w') as f:
        json.dump(anno, f)
    return ann, feat_dir


def _iou(a, b):
    inter = max(0, min(a[1], b[1]) - max(a[0], b[0]))
    return inter / (a[1] - a[0] + b[1] - b[0] - inter)


def write_ssn_set(root, imwrite, n_videos=2, n_frames=120, hw=(20, 20),
                  num_classes=3, seed=0):
    """``video_{v}/img_{:05d}.jpg`` frames (written by ``imwrite(path,
    hwc_uint8)``) and ``proposal_list.txt`` in the SSN format: each video
    with 1-2 gts, and proposals of each kind the sampler takes (positives
    jittered from the gts, incomplete pieces inside them, backgrounds
    clear of them), with their true best IoU and overlap."""
    rng = np.random.default_rng(seed)
    lines = []
    for v in range(n_videos):
        vdir = osp.join(root, f'video_{v}')
        os.makedirs(vdir, exist_ok=True)
        for i in range(1, n_frames + 1):
            imwrite(osp.join(vdir, f'img_{i:05d}.jpg'),
                    rng.integers(0, 256, hw + (3,), dtype=np.uint8))
        n_gt = 1 + v % 2
        span = n_frames // n_gt
        gts = []
        for k in range(n_gt):
            s = k * span + int(rng.integers(span // 8, span // 4))
            e = s + int(rng.integers(span // 3, span // 2))
            gts.append((int(rng.integers(1, num_classes + 1)), s, e))
        props = []
        for label, s, e in gts:
            d = e - s
            for _ in range(2):      # positives
                ps = s + int(rng.integers(-d // 20, d // 20 + 1))
                pe = e + int(rng.integers(-d // 20, d // 20 + 1))
                props.append((ps, pe))
            for _ in range(3):      # incomplete: a short piece inside
                ps = s + int(rng.integers(0, d // 2))
                props.append((ps, ps + max(2, d // 5)))
        free = [f for f in range(n_frames - 6)
                if all(f + 6 <= s or f >= e for _, s, e in gts)]
        for f in rng.choice(free, 2, replace=False):   # backgrounds
            props.append((int(f), int(f) + 6))
        rows = []
        for ps, pe in props:
            ious = [_iou((ps, pe), (s, e)) for _, s, e in gts]
            j = int(np.argmax(ious))
            _, s, e = gts[j]
            overlap = max(0, min(pe, e) - max(ps, s)) / (pe - ps)
            label = gts[j][0] if ious[j] > 0 else 0
            rows.append(f'{label} {ious[j]:.4f} {overlap:.4f} {ps} {pe}')
        lines += [f'# {v}', f'video_{v}', str(n_frames), '1', str(n_gt)]
        lines += [f'{label} {s} {e}' for label, s, e in gts]
        lines += [str(len(rows))] + rows
    ann = osp.join(root, 'proposal_list.txt')
    with open(ann, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return ann


def write_hvu(root, imwrite, n_videos=4, n_frames=16, hw=(32, 40),
              category_nums=(('action', 12), ('scene', 5)), seed=0):
    """``video_{v}`` rawframes from ``img_00000.jpg`` (HVUDataset's
    default start_index, 0) and ``hvu.json``: a list of {frame_dir,
    total_frames, label {category: [tags]}}, some categories absent."""
    rng = np.random.default_rng(seed)
    infos = []
    for v in range(n_videos):
        vdir = osp.join(root, f'video_{v}')
        os.makedirs(vdir, exist_ok=True)
        for i in range(n_frames):
            imwrite(osp.join(vdir, f'img_{i:05d}.jpg'),
                    rng.integers(0, 256, hw + (3,), dtype=np.uint8))
        label = {c: sorted(int(t) for t in rng.choice(n, 1 + v % 2,
                                                      replace=False))
                 for k, (c, n) in enumerate(category_nums)
                 if k == 0 or v % 2}
        infos.append(dict(frame_dir=f'video_{v}', total_frames=n_frames,
                          label=label))
    ann = osp.join(root, 'hvu.json')
    with open(ann, 'w') as f:
        json.dump(infos, f)
    return ann
