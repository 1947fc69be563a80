"""Aggregate ablation-ordering arm JSONs into one table + evidence JSON.

    python -m mscl_torch.tools.ablation_summary [--dir DIR] [--scale S]
        [--out PATH]

A copy of ``tools/analysis/ablation_summary.py`` (pure Python over the
JSONs of ``mscl_torch.tools.ablation_ordering``).

Reads {dir}/{arm}_{scale}_s{seed}.json (one file per arm x seed; the
default dir is where the ordering tool writes; docs/evidence/ablation
holds the JAX tool's), and prints the markdown table: per-arm mean
(min-max over seeds) of the final downstream metrics, with the shared
random-init row as the floor, then the ordering checks the paper's central
table implies (MSCL > MoDist > MoCo at motion-discriminative
representation), and writes them with ``--out``.
"""
import argparse
import glob
import json
import os
import re

ARM_ORDER = ('moco', 'modist', 'mscl_nofra', 'mscl', 'mscl_nomds')
ARM_LABEL = {
    'moco': 'MoCoV2 (RGB only)',
    'modist': 'MoDist (+flow tower, cross-modal)',
    'mscl_nofra': 'MSCL w/o FRA (single flow pass)',
    'mscl': 'MSCL full (FRA double pass)',
    'mscl_nomds': 'MSCL w/o MDS (uniform sampling)',
}


def collect(out_dir, scale):
    runs = {}
    for path in sorted(glob.glob(os.path.join(
            out_dir, f'*_{scale}_s*.json'))):
        name = os.path.basename(path)
        m = re.match(rf'(\w+?)_{scale}_s(\d+)\.json$', name)
        if not m or m.group(1) not in ARM_ORDER:
            continue
        with open(path) as f:
            d = json.load(f)
        runs.setdefault(m.group(1), {})[int(m.group(2))] = d
    return runs


def flat(metrics):
    return {'motion_R@1': metrics['motion']['R@1'],
            'motion_R@5': metrics['motion']['R@5'],
            'probe_acc': metrics['probe_acc'],
            'instance_R@1': metrics['instance_R1']}


def agg(vals):
    lo, hi = min(vals), max(vals)
    mean = sum(vals) / len(vals)
    if len(vals) == 1:
        return f'{mean:.3f}'
    return f'{mean:.3f} [{lo:.3f}-{hi:.3f}]'


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--dir', default='work_dirs/ablation')
    p.add_argument('--scale', default='full')
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)

    runs = collect(args.dir, args.scale)
    if not runs:
        raise SystemExit(f'no {args.scale}-scale arm JSONs in {args.dir}')

    cols = ('motion_R@1', 'motion_R@5', 'probe_acc', 'instance_R@1')
    print(f'| arm | seeds | {" | ".join(cols)} |')
    print('|' + '---|' * (len(cols) + 2))

    # shared random-init floor (same data + eval across arms; init
    # differs only by arm architecture -> report the multi-tower one)
    init_src = runs.get('mscl') or next(iter(runs.values()))
    init = flat(init_src[min(init_src)]['init'])
    print('| random init (floor) | — | ' +
          ' | '.join(f'{init[c]:.3f}' for c in cols) + ' |')

    summary = {'scale': args.scale, 'init_floor': init, 'arms': {}}
    for arm in ARM_ORDER:
        if arm not in runs:
            continue
        seeds = sorted(runs[arm])
        per = {c: [flat(runs[arm][s]['final'])[c] for s in seeds]
               for c in cols}
        summary['arms'][arm] = {
            'label': ARM_LABEL[arm], 'seeds': seeds,
            'final_mean': {c: sum(v) / len(v) for c, v in per.items()},
            'final_per_seed': per,
            'init_per_seed': {c: [flat(runs[arm][s]['init'])[c]
                                  for s in seeds] for c in cols},
        }
        print(f'| {ARM_LABEL[arm]} | {len(seeds)} | ' +
              ' | '.join(agg(per[c]) for c in cols) + ' |')

    # the ordering verdicts the paper's table implies
    def mean_of(arm, c):
        return summary['arms'][arm]['final_mean'][c] \
            if arm in summary['arms'] else None

    checks = {}
    for c in ('motion_R@1', 'probe_acc'):
        mscl, modist, moco = (mean_of('mscl', c), mean_of('modist', c),
                              mean_of('moco', c))
        if None not in (mscl, modist, moco):
            checks[f'{c}: MSCL > MoCo'] = bool(mscl > moco)
            checks[f'{c}: MoDist > MoCo'] = bool(modist > moco)
            checks[f'{c}: MSCL > MoDist'] = bool(mscl > modist)
    summary['ordering_checks'] = checks
    print()
    for k, v in checks.items():
        print(f'  {"PASS" if v else "FAIL"}  {k}')

    if args.out:
        with open(args.out, 'w') as f:
            json.dump(summary, f, indent=1)
        print(f'\nwrote {args.out}')
    return summary


if __name__ == '__main__':
    main()
