"""RAFT flows, their colour-wheel images and motion boxes for one directory
of frames.

Port of ``tools/vis_flow.py``, with the same flags plus ``--device``
(default: the card):

    python -m mscl_torch.tools.vis_flow FRAME_DIR [--weights raft.pth] \\
        [--gap 8] [--adjacent 8] [--iters 12] [--out-dir vis_flow_out] \\
        [--no-bbox] [--resize W H] [--device cpu]

The frames (``*.jpg`` and ``*.png``, sorted) are read as RGB float32
(``utils/image_io.imread_rgb``) and, with ``--resize``, resized as
``cv2.resize`` does (``imresize``); pairs (i, min(i + adjacent, n - 1)) for
i in range(0, max(n - adjacent, 1), gap) go through RAFT in one batch
(``apis/flow_extraction.make_raft_fn``: the correlation lookup is the
hand-written kernel on the card; random weights without ``--weights``).
It writes ``flow_{k:04d}.jpg`` with the port's JPEG encoder and, unless
``--no-bbox``, the smoothed boxes of ``flow/flow_bbox.inference_bboxs`` as
``bboxes.npy``. RAFT needs frames of at least 64 pixels a side (8 after
its 1/8 encoder, for the 4-level pyramid).
"""
from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import sys
import time

import numpy as np

from ..apis.flow_extraction import make_raft_fn
from ..flow.flow_bbox import inference_bboxs
from ..utils.flow_viz import flow_to_image
from ..utils.image_io import imread_rgb, imresize
from ..utils.jpeg import imwrite


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('frame_dir', help='directory of video frames (jpg/png)')
    p.add_argument('--weights', default='',
                   help='torch RAFT checkpoint (.pth); random init if '
                        'empty (smoke mode)')
    p.add_argument('--gap', type=int, default=8,
                   help='stride between flow frames')
    p.add_argument('--adjacent', type=int, default=8,
                   help='frame offset of each flow pair')
    p.add_argument('--iters', type=int, default=12)
    p.add_argument('--out-dir', default='vis_flow_out')
    p.add_argument('--no-bbox', action='store_true')
    p.add_argument('--resize', type=int, nargs=2, default=None,
                   metavar=('W', 'H'),
                   help='resize frames before inference (RAFT needs '
                        '>=64px after the 1/8 encoder for its 4-level '
                        'pyramid)')
    p.add_argument('--device', default=None,
                   help="torch device (default: the card; 'cpu' to run on "
                        'the CPU)')
    return p.parse_args(argv)


def load_frames(frame_dir, resize=None):
    paths = sorted(glob.glob(osp.join(frame_dir, '*.jpg')) +
                   glob.glob(osp.join(frame_dir, '*.png')))
    assert paths, f'no frames under {frame_dir}'
    frames = [imread_rgb(f).astype(np.float32) for f in paths]
    if resize:
        frames = [imresize(f, tuple(resize)) for f in frames]
    return frames


def pair_indices(n, gap, adjacent):
    idx1 = list(range(0, max(n - adjacent, 1), gap))
    return idx1, [min(i + adjacent, n - 1) for i in idx1]


def write_outputs(flows, n, args):
    """The flow images and, unless ``--no-bbox``, ``bboxes.npy``; returns
    the boxes (None with ``--no-bbox``)."""
    os.makedirs(args.out_dir, exist_ok=True)
    for k, fl in enumerate(flows):
        imwrite(osp.join(args.out_dir, f'flow_{k:04d}.jpg'),
                flow_to_image(fl)[..., ::-1])
    print(f'wrote {len(flows)} flow visualizations to {args.out_dir}')
    if args.no_bbox:
        return None
    boxes, picked, stats = inference_bboxs(
        n, list(flows), gap=args.gap, adjacent=args.adjacent)
    np.save(osp.join(args.out_dir, 'bboxes.npy'),
            np.asarray(boxes, dtype=object), allow_pickle=True)
    freq_dict, found_freq, picked_freq, aver_vary, corner = stats
    print(f'{len(boxes)} smoothed bboxes ({len(picked)} picked, '
          f'found_freq={found_freq:.3f} picked_freq='
          f'{picked_freq:.3f} corner_freq={corner:.3f}) -> '
          f'{args.out_dir}/bboxes.npy')
    return boxes


def main(argv=None):
    """Returns (flows, boxes)."""
    args = parse_args(argv)
    try:
        frames = load_frames(args.frame_dir, args.resize)
    except (FileNotFoundError, ValueError) as e:
        sys.exit(f'unreadable image: {e}')
    n = len(frames)
    idx1, idx2 = pair_indices(n, args.gap, args.adjacent)
    print(f'{n} frames -> {len(idx1)} flow pairs '
          f'(gap={args.gap}, adjacent={args.adjacent})')

    raft_fn = make_raft_fn(args.weights or None, iters=args.iters,
                           device=args.device)
    st = time.time()
    img1 = np.stack([frames[i] for i in idx1])
    img2 = np.stack([frames[i] for i in idx2])
    flows = np.asarray(raft_fn(img1, img2))
    print(f'RAFT inference: {time.time() - st:.2f}s, '
          f'flow shape {flows.shape}, '
          f'max {flows.max():.2f} min {flows.min():.2f} '
          f'mean {flows.mean():.4f}')
    return flows, write_outputs(flows, n, args)


if __name__ == '__main__':
    main()
