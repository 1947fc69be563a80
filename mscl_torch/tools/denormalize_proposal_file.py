"""Denormalize an SSN ``normalized_`` proposal file into frame units.

    python -m mscl_torch.tools.denormalize_proposal_file
        NORMALIZED_PROPOSAL_FILE FRAMES_ROOT

Port of ``tools/data/denormalize_proposal_file.py`` (reference
tools/data/denormalize_proposal_file.py:10-52): each video's fractional gt
and proposal boundaries times its frame count (the ``.jpg`` / ``.png``
files of its directory under FRAMES_ROOT), written beside the input
without the ``normalized_`` prefix, which ``SSNDataset`` reads.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Dict, Optional, Sequence

from ..localization import load_localize_proposal_file


def count_frames(frames_root: str) -> Dict[str, int]:
    out = {}
    for name in sorted(os.listdir(frames_root)):
        vdir = osp.join(frames_root, name)
        if osp.isdir(vdir):
            out[name] = len([f for f in os.listdir(vdir)
                             if f.endswith(('.jpg', '.png'))])
    return out


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description='Denormalize a proposal file')
    p.add_argument('norm_proposal_file')
    p.add_argument('frames_root', help='rawframes root (frame counts)')
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Returns the path written."""
    args = parse_args(argv)
    assert 'normalized_' in osp.basename(args.norm_proposal_file)
    out_file = args.norm_proposal_file.replace('normalized_', '')
    frame_counts = count_frames(args.frames_root)
    blocks = []
    infos = load_localize_proposal_file(args.norm_proposal_file)
    for idx, (video_id, _, gts, props) in enumerate(infos):
        n = frame_counts[video_id]
        gt_rows = [f'{int(g[0])} {int(float(g[1]) * n)} '
                   f'{int(float(g[2]) * n)}' for g in gts]
        prop_rows = [
            f'{int(x[0])} {float(x[1]):.04f} {float(x[2]):.04f} '
            f'{int(float(x[3]) * n)} {int(float(x[4]) * n)}'
            for x in props]
        block = [f'# {idx}', video_id, str(n), '1', str(len(gt_rows))]
        block += gt_rows + [str(len(prop_rows))] + prop_rows
        blocks.append('\n'.join(block))
    with open(out_file, 'w') as f:
        f.write('\n'.join(blocks) + '\n')
    print(f'wrote {out_file}')
    return out_file


if __name__ == '__main__':
    main()
