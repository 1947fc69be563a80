"""Merge sharded annotation pickles into one.

    python -m mscl_torch.tools.merge_pkls 'annos_shard*.pkl' OUT.pkl
        [--dedup-key video_name]

Port of ``tools/misc/merge_pkls.py`` (reference tools/misc/merge_pkls.py):
the files the glob matches, in sorted order, each a list of annotation
dicts, concatenated, keeping the first entry of each ``--dedup-key`` value
(entries without the key are all kept), pickled to OUT. The shards are
those ``python -m mscl_torch.apis.flow_extraction --num-shards N
--shard-index i`` writes; that CLI deals the videos out in turn, so the
merged list holds every video once, shard by shard.
"""
from __future__ import annotations

import argparse
import glob
import pickle
from typing import List, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='Merge annotation shards')
    parser.add_argument('pattern', help="shard glob, e.g. 'annos_shard*.pkl'")
    parser.add_argument('out')
    parser.add_argument('--dedup-key', default='video_name')
    return parser.parse_args(argv)


def merge(paths: Sequence[str], dedup_key: str = 'video_name') -> List:
    merged, seen = [], set()
    for path in paths:
        with open(path, 'rb') as f:
            annos = pickle.load(f)
        for a in annos:
            key = a.get(dedup_key)
            if key is not None and key in seen:
                continue
            if key is not None:
                seen.add(key)
            merged.append(a)
    return merged


def main(argv: Optional[Sequence[str]] = None) -> List:
    """Returns the merged list."""
    args = parse_args(argv)
    paths = sorted(glob.glob(args.pattern))
    if not paths:
        raise FileNotFoundError(f'no files match {args.pattern}')
    merged = merge(paths, args.dedup_key)
    with open(args.out, 'wb') as f:
        pickle.dump(merged, f)
    print(f'{len(paths)} shards -> {len(merged)} annotations -> {args.out}')
    return merged


if __name__ == '__main__':
    main()
