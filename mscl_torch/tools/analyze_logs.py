"""Timing statistics and loss curves of the Runner's ``log.json``.

    python -m mscl_torch.tools.analyze_logs cal_train_time LOG.json ...
        [--include-outliers]
    python -m mscl_torch.tools.analyze_logs plot_curve LOG.json ...
        [--keys loss ...] [--out PLOT.png] [--title ...]

Port of ``tools/analysis/analyze_logs.py`` (reference
tools/analysis/analyze_logs.py ``cal_train_time``, ``plot_curve``): one
JSON record a line; the train records' ``time`` (the first one left out
unless ``--include-outliers``) and ``data_time``. ``plot_curve`` needs
matplotlib, imported when it runs.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

import numpy as np


def load_json_log(path: str) -> List[Dict]:
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def cal_train_time(records, include_outliers: bool = False):
    """Prints the slowest, fastest, spread and mean iteration time and the
    mean data time; returns them (None without timed train records)."""
    train = [r for r in records if r.get('mode') == 'train'
             and 'time' in r]
    if not train:
        print('no train records with timing found')
        return None
    times = np.array([r['time'] for r in train])
    if not include_outliers:
        times = times[1:] if len(times) > 1 else times
    data_times = np.array([r.get('data_time', 0.0) for r in train])
    print(f'slowest iter time: {times.max():.4f}s')
    print(f'fastest iter time: {times.min():.4f}s')
    print(f'time std over iters: {times.std():.4f}s')
    print(f'average iter time: {times.mean():.4f}s')
    print(f'average data time: {data_times.mean():.4f}s')
    return dict(slowest=times.max(), fastest=times.min(), std=times.std(),
                mean=times.mean(), data_mean=data_times.mean())


def plot_curve(records, keys, out=None, title=None):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    for key in keys:
        xs, ys = [], []
        for i, r in enumerate(records):
            if key in r:
                xs.append(i)
                ys.append(r[key])
        plt.plot(xs, ys, label=key)
    plt.legend()
    if title:
        plt.title(title)
    if out:
        plt.savefig(out)
        print(f'saved plot to {out}')
    else:
        print('specify --out to save the plot')


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='Analyze json logs')
    sub = parser.add_subparsers(dest='task', required=True)
    p1 = sub.add_parser('cal_train_time')
    p1.add_argument('json_logs', nargs='+')
    p1.add_argument('--include-outliers', action='store_true')
    p2 = sub.add_parser('plot_curve')
    p2.add_argument('json_logs', nargs='+')
    p2.add_argument('--keys', nargs='+', default=['loss'])
    p2.add_argument('--out', default=None)
    p2.add_argument('--title', default=None)
    args = parser.parse_args(argv)

    out = {}
    for path in args.json_logs:
        records = load_json_log(path)
        print(f'----- {path} ({len(records)} records) -----')
        if args.task == 'cal_train_time':
            out[path] = cal_train_time(records, args.include_outliers)
        else:
            plot_curve(records, args.keys, args.out, args.title)
    return out


if __name__ == '__main__':
    main()
