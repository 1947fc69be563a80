"""Fuse several result pickles (a weighted sum of scores) and report
their accuracy.

    python -m mscl_torch.tools.report_accuracy --scores A.pkl B.pkl
        [--coefficients 1 0.5] --datalist LIST.txt|ANN.pkl [--apply-softmax]

Port of ``tools/analysis/report_accuracy.py``: the labels from the last
column of a text list or the ``label`` of each entry of a pickle, top-1,
top-5 and mean class accuracy of the fused scores.
"""
from __future__ import annotations

import argparse
import pickle
from typing import Dict, Optional, Sequence

import numpy as np

from ..core.evaluation import mean_class_accuracy, top_k_accuracy


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Prints and returns the three accuracies."""
    parser = argparse.ArgumentParser(description='Fuse results')
    parser.add_argument('--scores', nargs='+', required=True,
                        help='result pickles (lists of per-video scores)')
    parser.add_argument('--coefficients', nargs='+', type=float,
                        default=None)
    parser.add_argument('--datalist', required=True,
                        help='annotation txt with labels in last column '
                             'or a pickle with label fields')
    parser.add_argument('--apply-softmax', action='store_true')
    args = parser.parse_args(argv)

    score_sets = []
    for path in args.scores:
        with open(path, 'rb') as f:
            score_sets.append([np.asarray(s) for s in pickle.load(f)])
    coeffs = args.coefficients or [1.0] * len(score_sets)
    if len(coeffs) != len(score_sets):
        raise ValueError(f'{len(coeffs)} coefficients for '
                         f'{len(score_sets)} score files')
    if args.datalist.endswith('.pkl'):
        with open(args.datalist, 'rb') as f:
            annos = pickle.load(f)
        if isinstance(annos, dict):
            annos = list(annos.values())
        labels = [int(a['label']) for a in annos]
    else:
        with open(args.datalist) as f:
            labels = [int(line.split()[-1]) for line in f if line.strip()]

    def softmax(x):
        e = np.exp(x - x.max())
        return e / e.sum()

    fused = [sum(c * (softmax(s[i]) if args.apply_softmax else s[i])
                 for c, s in zip(coeffs, score_sets))
             for i in range(len(labels))]
    top1, top5 = top_k_accuracy(fused, labels, (1, 5))
    mca = mean_class_accuracy(fused, labels)
    print(f'top1_acc: {top1:.4f}')
    print(f'top5_acc: {top5:.4f}')
    print(f'mean_class_accuracy: {mca:.4f}')
    return dict(top1_acc=top1, top5_acc=top5, mean_class_accuracy=mca)


if __name__ == '__main__':
    main()
