"""Offline optical-flow extraction with RAFT: frames -> np4 flow blobs and
the annotation pickle that MSCL pretraining reads (``enc_flows``).

Port of ``tools/misc/flow_extraction.py`` for ``--method raft``:

    python -m mscl_torch.apis.flow_extraction FRAMES_ROOT FLOW_OUT \\
        --anno-out annos.pkl --raft-weights raft-things.pth --scale-hw 128 171

Same flags, plus ``--device`` (default: the card). Each video directory of
FRAMES_ROOT gives flow pairs (i, i + adjacent) every ``gap`` frames, run in
batches through RAFT and written as ``FLOW_OUT/<video>/flow_XXXXX.np4``.
Frames (JPEG or PNG) are read and resized without cv2 and the blobs
written without msgpack (``utils/image_io``, ``utils/np4``), so the CLI
runs where neither is installed.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
import sys

import numpy as np
import torch

from ..flow.raft import build_raft
from ..utils.image_io import imread_rgb, imresize
from ..utils.np4 import np4_encode
from .train import resolve_device


def window_indices(num_frames, gap=2, adjacent=8):
    """Flow-pair frame indices (i, i + adjacent) for i in
    range(0, num_frames - adjacent, gap)."""
    return [(i, i + adjacent) for i in range(0, num_frames - adjacent, gap)]


def make_raft_fn(weights_path, iters=12, device=None):
    """RAFT as a function of two (B, H, W, 3) image batches in [0, 255]
    (numpy, any real dtype) -> (B, H, W, 2) float32 flow (numpy). H and W
    are padded with edge pixels to multiples of 8 and the flow is cropped
    back."""
    device = resolve_device(device)
    if not weights_path:
        print('WARNING: no RAFT weights given - using random init '
              '(only useful for pipeline smoke tests)', file=sys.stderr)
    model = build_raft(weights_path, device=device, iters=iters)

    def to_device(batch):
        return torch.from_numpy(np.ascontiguousarray(batch)).to(device) \
            .permute(0, 3, 1, 2).float().contiguous()

    def raft_fn(img1_batch, img2_batch):
        h, w = img1_batch.shape[1:3]
        ph, pw = (-h) % 8, (-w) % 8
        if ph or pw:
            pad = ((0, 0), (0, ph), (0, pw), (0, 0))
            img1_batch = np.pad(img1_batch, pad, mode='edge')
            img2_batch = np.pad(img2_batch, pad, mode='edge')
        with torch.inference_mode():
            _, flow_up = model(to_device(img1_batch), to_device(img2_batch))
            flow = flow_up.permute(0, 2, 3, 1).cpu().numpy()
        return flow[:, :h, :w]

    return raft_fn


def list_videos(frames_root):
    videos = []
    for name in sorted(os.listdir(frames_root)):
        vdir = osp.join(frames_root, name)
        if not osp.isdir(vdir):
            continue
        frames = sorted(
            osp.join(vdir, f) for f in os.listdir(vdir)
            if f.lower().endswith(('.jpg', '.jpeg', '.png')))
        if frames:
            videos.append((name, frames))
    return videos


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('frames_root',
                        help='dir of per-video frame directories')
    parser.add_argument('out_root', help='output dir for flow blobs')
    parser.add_argument('--anno-out', required=True,
                        help='output annotation pickle')
    parser.add_argument('--labels', default=None,
                        help='optional "video_name label" txt file')
    parser.add_argument('--method', default='raft', choices=['raft'],
                        help='only RAFT is ported (ARFlow and TVL1 are not)')
    parser.add_argument('--raft-weights', default=None,
                        help='official RAFT .pth')
    parser.add_argument('--iters', type=int, default=12)
    parser.add_argument('--gap', type=int, default=2)
    parser.add_argument('--adjacent', type=int, default=8)
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--scale-hw', type=int, nargs=2, default=None,
                        help='resize frames before flow (h w); flow is '
                             'stored at this resolution')
    parser.add_argument('--num-shards', type=int, default=1)
    parser.add_argument('--shard-index', type=int, default=0)
    parser.add_argument('--device', default=None,
                        help="torch device (default: the card; 'cpu' to "
                             'run on the CPU)')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    labels = {}
    if args.labels:
        with open(args.labels) as f:
            for line in f:
                name, lab = line.split()
                labels[name] = int(lab)

    flow_fn = make_raft_fn(args.raft_weights, args.iters, args.device)

    def load(path):
        # cv2.imread + cv2.resize (INTER_LINEAR) of the JAX CLI, bit for bit
        img = imread_rgb(path)
        if args.scale_hw:
            img = imresize(img, (args.scale_hw[1], args.scale_hw[0]),
                           'bilinear')
        return img

    videos = list_videos(args.frames_root)
    videos = videos[args.shard_index::args.num_shards]
    os.makedirs(args.out_root, exist_ok=True)
    annos = []
    for vid_idx, (name, frames) in enumerate(videos):
        pairs = window_indices(len(frames), args.gap, args.adjacent)
        if not pairs:
            continue
        vout = osp.join(args.out_root, name)
        os.makedirs(vout, exist_ok=True)
        flow_paths = []
        for start in range(0, len(pairs), args.batch_size):
            chunk = pairs[start:start + args.batch_size]
            img1 = np.stack([load(frames[i]) for i, _ in chunk])
            img2 = np.stack([load(frames[j]) for _, j in chunk])
            for flow in flow_fn(img1, img2):
                p = osp.join(vout, f'flow_{len(flow_paths):05d}.np4')
                with open(p, 'wb') as f:
                    f.write(np4_encode(flow.astype(np.float32)))
                flow_paths.append(p)
        annos.append(dict(frames=frames, enc_flows=flow_paths,
                          label=labels.get(name, 0), video_name=name))
        if (vid_idx + 1) % 10 == 0:
            print(f'{vid_idx + 1}/{len(videos)} videos done')

    with open(args.anno_out, 'wb') as f:
        pickle.dump(annos, f)
    print(f'wrote {len(annos)} videos -> {args.anno_out}')


if __name__ == '__main__':
    main()
