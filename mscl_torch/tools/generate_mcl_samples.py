"""Motion Differential Sampling (MDS): pick each video's clip starts from
its flows, for MSCL pretraining's ``chosen_idx``.

Port of ``tools/ssl/generate_mcl_samples.py``, with the same flags:

    python -m mscl_torch.tools.generate_mcl_samples ANNO_PKL OUT_PKL \\
        [--weight-type motion_map] [--pool-type avg] [--num-workers 8]

Per video: a weight map for each flow (the Sobel motion-edge map, its
pooled attention map, or the frame difference of colour-wheel images),
pooled per frame, summed over a clip window (``clip_len`` flows
``clip_stride`` apart); ``chosen_idx`` keeps the clip starts whose weight
exceeds the median. Flows are the annotation's ``enc_flows`` (``.np4`` or
``.npy``); ``--num-workers`` spreads the videos over spawned processes.
It needs neither cv2 nor msgpack: ``utils/np4`` reads the blobs,
``utils/image_io.imresize`` is cv2's float32 INTER_LINEAR, and the Sobel
filter is scipy's, as the JAX tool calls it.
"""
from __future__ import annotations

import argparse
import multiprocessing
import pickle

import numpy as np
from scipy import ndimage

from ..utils.flow_viz import flow_to_image
from ..utils.image_io import imresize
from ..utils.np4 import np4_decode


def cal_motion_map(flow: np.ndarray) -> np.ndarray:
    """Gradient-magnitude motion-edge map (reference :20-31)."""
    u, v = flow[..., 0], flow[..., 1]
    s = [ndimage.sobel(u, axis=-1), ndimage.sobel(u, axis=0),
         ndimage.sobel(v, axis=-1), ndimage.sobel(v, axis=0)]
    return np.sqrt(sum(np.square(g) for g in s))


def cal_attention_map(mp: np.ndarray, att_type='max') -> np.ndarray:
    """Avg-pool(28) + bilinear upsample + normalize (reference :33-46)."""
    sl = 28
    h, w = mp.shape
    ph, pw = max(h // sl, 1), max(w // sl, 1)
    pooled = mp[:ph * sl, :pw * sl].reshape(ph, sl, pw, sl).mean((1, 3))
    up = imresize(pooled, (w, h), 'bilinear')
    if att_type == 'max':
        return up / max(up.max(), 1e-12)
    if att_type == 'sum':
        return up / max(up.sum(), 1e-12)
    raise ValueError(f'unknown att_type {att_type}')


def cal_rgb_map(flow: np.ndarray, att_type='none') -> np.ndarray:
    """Color-wheel RGB map, optionally attention-weighted
    (reference :49-62)."""
    rgb = flow_to_image(flow, convert_to_bgr=False).astype(np.float32)
    if att_type == 'none':
        return rgb
    att = cal_attention_map(cal_motion_map(flow), att_type)[..., None]
    return att * rgb


def process_single_flow(flow, weight_type, att_type='none'):
    if weight_type == 'motion_map':
        return cal_motion_map(flow)
    if weight_type == 'attention_map':
        return cal_attention_map(cal_motion_map(flow), att_type)
    if weight_type == 'rgb_map':
        return cal_rgb_map(flow, att_type)
    raise ValueError(f'unknown weight_type {weight_type}')


def load_flow(path):
    if path.endswith('.npy'):
        return np.load(path)
    with open(path, 'rb') as f:
        flow = np4_decode(f.read())
    if flow is None:
        raise IOError(f'failed to decode flow blob: {path}')
    return flow


def process_video(meta, weight_type='motion_map', att_type='none',
                  pool_type='avg', clip_len=8, clip_stride=4):
    """chosen_idx = clip starts whose summed weight > median
    (reference :76-134)."""
    pool_func = (lambda x: x.mean((0, 1))) if pool_type == 'avg' else \
        (lambda x: x.max((0, 1)))
    video_weights = [
        process_single_flow(load_flow(p), weight_type, att_type)
        for p in meta['enc_flows']]

    if 'rgb' in weight_type:
        # frame differential of the RGB maps (reference :104-112)
        video_weights.append(video_weights[-1])
        video_weights = [
            np.linalg.norm(video_weights[i] - video_weights[i + 1],
                           axis=-1)
            for i in range(len(video_weights) - 1)]

    vid_len = len(video_weights)
    frame_weights = [pool_func(w) for w in video_weights]
    clip_weights = []
    for i in range(vid_len):
        cur = 0.0
        for j in range(clip_len):
            if i + j * clip_stride < vid_len:
                cur += frame_weights[i + j * clip_stride]
        clip_weights.append(cur / clip_len)

    clip_median = np.median(clip_weights)
    meta = dict(meta)
    meta['chosen_idx'] = [i for i, v in enumerate(clip_weights)
                          if v > clip_median]
    return meta


def _worker(args):
    meta, kwargs = args
    return process_video(meta, **kwargs)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Generate MDS chosen_idx')
    parser.add_argument('anno_pkl', help='annotation pickle (list of '
                        'dicts with enc_flows)')
    parser.add_argument('out_pkl', help='output pickle')
    parser.add_argument('--weight-type', default='motion_map',
                        choices=['motion_map', 'attention_map', 'rgb_map'])
    parser.add_argument('--att-type', default='none')
    parser.add_argument('--pool-type', default='avg',
                        choices=['avg', 'max'])
    parser.add_argument('--clip-len', type=int, default=8)
    parser.add_argument('--clip-stride', type=int, default=4)
    parser.add_argument('--num-workers', type=int, default=1)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    with open(args.anno_pkl, 'rb') as f:
        annos = pickle.load(f)
    if isinstance(annos, dict):
        annos = list(annos.values())
    kwargs = dict(weight_type=args.weight_type, att_type=args.att_type,
                  pool_type=args.pool_type, clip_len=args.clip_len,
                  clip_stride=args.clip_stride)
    if args.num_workers > 1:
        # spawned, not forked: the caller may hold threads (a trainer, a
        # CUDA context)
        ctx = multiprocessing.get_context('spawn')
        with ctx.Pool(args.num_workers) as pool:
            out = pool.map(_worker, [(m, kwargs) for m in annos])
    else:
        out = [process_video(m, **kwargs) for m in annos]
    with open(args.out_pkl, 'wb') as f:
        pickle.dump(out, f)
    n_chosen = np.mean([len(m['chosen_idx']) for m in out])
    print(f'wrote {len(out)} videos, mean chosen_idx per video: '
          f'{n_chosen:.1f}')
    return out


if __name__ == '__main__':
    main()
