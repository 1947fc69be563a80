"""BSN's proposal generation (PGM): TEM results -> candidate proposals and
their boundary-sensitive features, PEM's training and test data.

    python -m mscl_torch.tools.bsn_proposal_generation ANN_FILE
        --tem-results-dir DIR --pgm-proposals-dir DIR
        --pgm-features-dir DIR [--temporal-scale 100]
        [--peak-threshold 0.5] [--top-k 1000] [--num-workers 1]

Port of ``tools/misc/bsn_proposal_generation.py`` (reference
tools/misc/bsn_proposal_generation.py:14-195), through the port's copy of
the PGM (``mscl_torch/localization/bsn_utils.py``): for each video of the
ActivityNet json, its TEM csv (``action,start,end,tmin,tmax`` rows) gives
the proposals' csv (``tmin,tmax,tmin_score,tmax_score,score,match_iou,
match_ioa``) and the first ``--top-k`` proposals' features (``.npy``),
which ``LoadProposals`` reads. ``--num-workers`` > 1 shares the videos out
over a pool of forked processes, one shard each.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import os.path as osp
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..localization import generate_bsp_feature, generate_candidate_proposals

HEADER = 'tmin,tmax,tmin_score,tmax_score,score,match_iou,match_ioa'


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description='BSN proposal generation')
    p.add_argument('ann_file')
    p.add_argument('--tem-results-dir', required=True)
    p.add_argument('--pgm-proposals-dir', required=True)
    p.add_argument('--pgm-features-dir', required=True)
    p.add_argument('--temporal-scale', type=int, default=100)
    p.add_argument('--peak-threshold', type=float, default=0.5)
    p.add_argument('--top-k', type=int, default=1000)
    p.add_argument('--num-workers', type=int, default=1)
    return p.parse_args(argv)


def load_video_infos(ann_file: str) -> List[Dict]:
    with open(ann_file) as f:
        anno = json.load(f)
    return [dict(video_name=name, **info) for name, info in anno.items()]


def _run_shard(job):
    """Proposals, then features, of one shard's videos (a pool worker)."""
    ids, video_infos, args = job
    props = generate_candidate_proposals(
        ids, video_infos, args.tem_results_dir, args.temporal_scale,
        args.peak_threshold)
    for name, arr in props.items():
        np.savetxt(osp.join(args.pgm_proposals_dir, name + '.csv'), arr,
                   delimiter=',', header=HEADER, comments='')
    feats = generate_bsp_feature(ids, video_infos, args.tem_results_dir,
                                 args.pgm_proposals_dir, top_k=args.top_k)
    for name, arr in feats.items():
        np.save(osp.join(args.pgm_features_dir, name + '.npy'), arr)
    return len(ids)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Returns the number of videos processed."""
    args = parse_args(argv)
    video_infos = load_video_infos(args.ann_file)
    ids = list(range(len(video_infos)))
    os.makedirs(args.pgm_proposals_dir, exist_ok=True)
    os.makedirs(args.pgm_features_dir, exist_ok=True)
    n = max(args.num_workers, 1)
    jobs = [(ids[w::n], video_infos, args) for w in range(n)]
    if n > 1:
        with mp.get_context('fork').Pool(n) as pool:
            done = sum(pool.map(_run_shard, jobs))
    else:
        done = _run_shard(jobs[0])
    print(f'PGM done: {done} videos -> {args.pgm_proposals_dir}, '
          f'{args.pgm_features_dir}')
    return done


if __name__ == '__main__':
    main()
