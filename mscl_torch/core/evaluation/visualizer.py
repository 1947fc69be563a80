"""ClfVisualizer — per-class accuracy deltas and confusion matrices.

A copy of ``mscl_tpu/core/evaluation/visualizer.py`` (reference
mmaction/core/evaluation/visualizer.py:58-150: dumps a confusion matrix and
a per-class accuracy table comparing the current run against a baseline run
directory; enabled via the 'vis_mean_class_accuracy' metric + visual_cfg).
"""
from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np

from .accuracy import confusion_matrix, per_class_accuracy


class ClfVisualizer:

    def __init__(self, cur_path, default_path=None, dataset_name='',
                 vis_acc=True, vis_cf=False, k=20):
        self.cur_path = cur_path
        self.default_path = default_path
        self.dataset_name = dataset_name
        self.vis_acc = vis_acc
        self.vis_cf = vis_cf
        self.k = k

    def _acc_file(self, path):
        return osp.join(path, f'per_class_acc_{self.dataset_name}.json')

    def visualize(self, results, gt_labels):
        os.makedirs(self.cur_path, exist_ok=True)
        classes, accs = per_class_accuracy(results, gt_labels)
        record = {int(c): float(a) for c, a in zip(classes, accs)}
        with open(self._acc_file(self.cur_path), 'w') as f:
            json.dump(record, f)

        if self.vis_acc and self.default_path:
            base_file = self._acc_file(self.default_path)
            if osp.exists(base_file):
                with open(base_file) as f:
                    base = {int(k): v for k, v in json.load(f).items()}
                deltas = sorted(
                    ((c, record[c] - base.get(c, 0.0)) for c in record),
                    key=lambda x: x[1])
                lines = ['class\tdelta_acc']
                for c, d in deltas[:self.k] + deltas[-self.k:]:
                    lines.append(f'{c}\t{d:+.4f}')
                with open(osp.join(self.cur_path,
                                   f'acc_delta_{self.dataset_name}.txt'),
                          'w') as f:
                    f.write('\n'.join(lines) + '\n')

        if self.vis_cf:
            pred = np.argmax(np.asarray(results), axis=1)
            cf = confusion_matrix(pred, gt_labels, normalize='true')
            np.save(osp.join(self.cur_path,
                             f'confusion_{self.dataset_name}.npy'), cf)
        return record
