"""Detection mAP of an ActivityNet proposal file.

    python -m mscl_torch.tools.report_map --proposal PROPOSALS.json
        --gt GT.json --cls-pred CLS_PRED.json [--det-output OUT.json]

Port of ``tools/analysis/report_map.py`` (reference
tools/analysis/report_map.py): each class-agnostic proposal of a video
takes the video's top-1 label of the video-level predictions
(``cuhk17_top1``, the CUHK-17 challenge file's format, given locally with
``--cls-pred``: nothing is downloaded), the labelled detections are written
to ``--det-output``, and ``ActivityNetDetection`` (the port's copy in
``mscl_torch/localization/det_eval.py``) gives the mAP at tIoU 0.5:0.05:0.95
and their mean.
"""
from __future__ import annotations

import argparse
import json
import os.path as osp
from typing import Dict, Optional, Sequence

import numpy as np

from ..localization.det_eval import ActivityNetDetection


def cuhk17_top1(args):
    """Label every proposal of a video with the video's top-1 prediction
    (reference report_map.py cuhk17_top1)."""
    if not osp.exists(args.cls_pred):
        raise FileNotFoundError(
            f'{args.cls_pred} not found: pass the video-level predictions '
            f'(cuhk_anet17_pred.json) with --cls-pred')
    with open(args.proposal) as f:
        proposal = json.load(f)
    with open(args.cls_pred) as f:
        cuhk_pred = json.load(f)['results']
    results = proposal['results']
    for k, v in results.items():
        preds = sorted(cuhk_pred[k], key=lambda x: x['score'])
        top1_label = preds[-1]['label']
        results[k] = [dict(label=top1_label, **item) for item in v]
    proposal['results'] = results
    with open(args.det_output, 'w') as f:
        json.dump(proposal, f)


CLS_FUNCS = {'cuhk17_top1': cuhk17_top1}


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(
        description='Report detection mAP for an ActivityNet proposal file')
    parser.add_argument('--proposal', type=str, help='proposal file')
    parser.add_argument('--gt', type=str,
                        default='data/ActivityNet/anet_anno_val.json',
                        help='groundtruth file')
    parser.add_argument('--cls', type=str, default='cuhk17_top1',
                        choices=list(CLS_FUNCS),
                        help='how to assign labels to proposals')
    parser.add_argument('--cls-pred', type=str,
                        default='cuhk_anet17_pred.json',
                        help='video-level classification predictions')
    parser.add_argument('--det-output', type=str, default='det_result.json',
                        help='path to store detection results')
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Returns the mAP at each tIoU and their mean."""
    args = parse_args(argv)
    CLS_FUNCS[args.cls](args)
    thresholds = np.linspace(0.5, 0.95, 10)
    anet_detection = ActivityNetDetection(
        args.gt, args.det_output, tiou_thresholds=thresholds, verbose=True)
    mAP, average_mAP = anet_detection.evaluate()
    print('[RESULTS] Performance on ActivityNet detection task.')
    print(f'mAP@tIoU {thresholds}: {mAP}')
    print(f'Average-mAP: {average_mAP}')
    return dict(mAP=mAP, average_mAP=average_mAP)


if __name__ == '__main__':
    main()
