"""Stored flow blobs -> colour-wheel flow images and motion pseudo-boxes.

Port of ``tools/misc/flow2img.py``, with the same arguments:

    python -m mscl_torch.tools.flow2img ANNO_PKL OUT_ROOT ANNO_OUT \\
        [--gap 2] [--adjacent 8] [--with-bboxes] \\
        [--num-shards N --shard-index I]

For each video of ANNO_PKL (and of this shard): its ``enc_flows`` blobs are
decoded (``utils/np4``), drawn with the colour wheel (``utils/flow_viz``)
and written as ``OUT_ROOT/<video>/flowimg_{fi:05d}.jpg`` (``imflows``) by
the port's JPEG encoder, the bytes ``cv2.imwrite`` writes; with
``--with-bboxes`` the flow -> box -> DP-smoothing pipeline
(``flow/flow_bbox.py``) adds ``gt_bboxes`` (float32, one box a frame),
``bbox_freq``, ``bbox_picked_freq`` and ``corner_bbox_freq``. The updated
annotations go to ANNO_OUT. Host numpy and scipy; it needs neither cv2 nor
msgpack.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle

import numpy as np

from ..flow.flow_bbox import inference_bboxs
from ..utils.flow_viz import flow_to_image
from ..utils.jpeg import imwrite
from ..utils.np4 import np4_decode


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('anno_pkl', help='annotations with enc_flows paths')
    p.add_argument('out_root', help='output dir for flow jpegs')
    p.add_argument('anno_out', help='updated annotation pkl')
    p.add_argument('--gap', type=int, default=2)
    p.add_argument('--adjacent', type=int, default=8)
    p.add_argument('--with-bboxes', action='store_true')
    p.add_argument('--num-shards', type=int, default=1)
    p.add_argument('--shard-index', type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    with open(args.anno_pkl, 'rb') as f:
        annos = pickle.load(f)
    os.makedirs(args.out_root, exist_ok=True)

    for idx in range(args.shard_index, len(annos), args.num_shards):
        anno = annos[idx]
        name = anno.get('video_name', f'video_{idx}')
        vout = osp.join(args.out_root, name)
        os.makedirs(vout, exist_ok=True)
        flows = []
        img_paths = []
        for fi, fp in enumerate(anno.get('enc_flows', [])):
            with open(fp, 'rb') as f:
                flow = np4_decode(f.read())
            flows.append(flow)
            out_path = osp.join(vout, f'flowimg_{fi:05d}.jpg')
            imwrite(out_path, flow_to_image(flow)[..., ::-1])
            img_paths.append(out_path)
        anno['imflows'] = img_paths
        if args.with_bboxes and flows:
            n_frames = len(anno.get('frames', [])) or \
                (len(flows) * args.gap + args.adjacent)
            boxes, picked, stats = inference_bboxs(
                n_frames, flows, gap=args.gap, adjacent=args.adjacent)
            anno['gt_bboxes'] = np.asarray(boxes, np.float32)
            anno['bbox_freq'] = stats[0]
            anno['bbox_picked_freq'] = float(stats[2])
            anno['corner_bbox_freq'] = float(stats[4])
        if (idx + 1) % 20 == 0:
            print(f'{idx + 1}/{len(annos)}')

    with open(args.anno_out, 'wb') as f:
        pickle.dump(annos, f)
    print(f'wrote {args.anno_out}')
    return annos


if __name__ == '__main__':
    main()
