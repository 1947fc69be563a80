"""Evaluate saved per-video scores against a config's test set.

    python -m mscl_torch.tools.eval_metric CONFIG RESULTS.pkl
        [--eval top_k_accuracy mean_class_accuracy ...] [--cfg-options ...]

Port of ``tools/analysis/eval_metric.py``: ``data.test`` built in test
mode (its annotations read, no frame decoded), the pickled list of scores
evaluated by the dataset, one ``name: value`` line a metric.
"""
from __future__ import annotations

import argparse
import pickle
from typing import Dict, Optional, Sequence

from ..config import Config, DictAction


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Prints and returns the metrics."""
    parser = argparse.ArgumentParser(description='Evaluate metrics from '
                                                 'saved results')
    parser.add_argument('config')
    parser.add_argument('results', help='pickle of per-video scores')
    parser.add_argument('--eval', nargs='+', default=['top_k_accuracy'])
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        default={})
    args = parser.parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)

    from ..apis.train import _plain
    from ..datasets import build_dataset
    dataset = build_dataset(dict(_plain(cfg.data['test']), test_mode=True))
    with open(args.results, 'rb') as f:
        results = pickle.load(f)
    metrics = dataset.evaluate(results, metrics=args.eval)
    for k, v in metrics.items():
        print(f'{k}: {v:.4f}')
    return metrics


if __name__ == '__main__':
    main()
