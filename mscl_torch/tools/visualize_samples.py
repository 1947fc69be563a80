"""Contact sheets of MDS/MSCL samples: each sampled frame beside its flow's
colour-wheel image and that image with the flow's candidate motion boxes.

Port of ``tools/misc/visualize_samples.py``, with the same arguments:

    python -m mscl_torch.tools.visualize_samples TRAIN_PKL OUT_DIR \\
        [--num-videos 4] [--frames-per-video 6]

TRAIN_PKL is a FileRawframeDataset annotation list (``frames`` paths,
``enc_flows`` np4 paths). Each row: frame ``2 fi`` resized to its flow's
size (``utils/image_io.imresize``, ``cv2.resize``'s INTER_LINEAR), the
flow image (``utils/flow_viz``), and the flow image with the boxes of
``flow/flow_bbox.flow_to_bbox`` drawn in green (``image_io.rectangle``).
Sheets are written as ``OUT_DIR/video_{v:04d}.jpg`` by the port's JPEG
encoder, the bytes ``cv2.imwrite`` writes. It needs neither cv2 nor
msgpack.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle

import numpy as np

from ..flow.flow_bbox import flow_to_bbox
from ..utils.flow_viz import flow_to_image
from ..utils.image_io import imread_rgb, imresize, rectangle
from ..utils.jpeg import imwrite
from ..utils.np4 import np4_decode


def render_video(anno, num_frames):
    """One video's sheet, RGB uint8, or None when no flow decodes."""
    frames = anno['frames']
    flows = anno.get('enc_flows', [])
    take = np.linspace(0, max(len(flows) - 1, 0),
                       num=min(num_frames, max(len(flows), 1)),
                       dtype=int)
    rows = []
    for fi in take:
        with open(flows[fi], 'rb') as f:
            flow = np4_decode(f.read())
        if flow is None:
            continue
        img = imread_rgb(frames[min(fi * 2, len(frames) - 1)])
        h, w = flow.shape[:2]
        img = imresize(img, (w, h))
        viz = flow_to_image(flow)
        boxed = viz.copy()
        for box in flow_to_bbox(flow):          # candidate motion boxes
            x1, y1, x2, y2 = (int(v) for v in box)
            rectangle(boxed, (x1, y1), (x2, y2), (0, 255, 0))
        rows.append(np.concatenate([img, viz, boxed], axis=1))
    return np.concatenate(rows, axis=0) if rows else None


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('pkl')
    p.add_argument('out_dir')
    p.add_argument('--num-videos', type=int, default=4)
    p.add_argument('--frames-per-video', type=int, default=6)
    return p.parse_args(argv)


def main(argv=None):
    """Returns the paths written."""
    args = parse_args(argv)
    with open(args.pkl, 'rb') as f:
        annos = pickle.load(f)
    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for v, anno in enumerate(annos[:args.num_videos]):
        sheet = render_video(anno, args.frames_per_video)
        if sheet is None:
            continue
        out = osp.join(args.out_dir, f'video_{v:04d}.jpg')
        imwrite(out, sheet[..., ::-1])
        written.append(out)
        print(f'wrote {out} ({sheet.shape[1]}x{sheet.shape[0]})')
    print(f'{len(written)} contact sheets in {args.out_dir}')
    return written


if __name__ == '__main__':
    main()
