"""Export a recognizer's inference as a ``torch.export`` program.

    python -m mscl_torch.tools.export CONFIG CHECKPOINT|''
        [--output-file model.pt2] [--shape 1 1 3 8 112 112] [--verify]
        [--cfg-options ...] [--device cuda|cpu]

Port of ``tools/deployment/export.py``, which serialises JAX's StableHLO
(reference tools/deployment/pytorch2onnx.py): here ``forward_test`` of the
model (its weights from the checkpoint, or seed 0 with '') traced by
``torch.export.export`` at ``--shape`` on the device and written by
``torch.export.save``. ``--verify`` loads the file back, runs it on a
seeded uniform batch and requires its scores within 1e-4 of the eager
model's.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import Config, DictAction


class Inference(nn.Module):
    """A recognizer's ``forward_test`` as a module's forward."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, imgs):
        return self.model.forward_test(imgs)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Returns the file, its bytes and, with --verify, the largest gap
    between the reloaded program's scores and the eager model's."""
    parser = argparse.ArgumentParser(
        description='export a recognizer with torch.export')
    parser.add_argument('config')
    parser.add_argument('checkpoint', help="checkpoint path or ''")
    parser.add_argument('--output-file', default='model.pt2')
    parser.add_argument('--shape', type=int, nargs='+',
                        default=[1, 1, 3, 8, 112, 112],
                        help='input imgs shape (NCTHW with clip dim)')
    parser.add_argument('--verify', action='store_true')
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        default={})
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)

    from ..apis.inference import init_recognizer
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    model, cfg = init_recognizer(cfg, args.checkpoint or None,
                                 device=args.device)
    dev = next(model.parameters()).device
    live = Inference(model).eval()
    x = torch.zeros(tuple(args.shape), device=dev)
    with torch.no_grad():
        program = torch.export.export(live, (x,), strict=False)
    torch.export.save(program, args.output_file)
    size = os.path.getsize(args.output_file)
    print(f'wrote {args.output_file} ({size / 1e6:.2f} MB, in '
          f'{tuple(args.shape)}, out '
          f'{tuple(program.module()(x).shape)})')
    out = dict(file=args.output_file, bytes=size)
    if args.verify:
        rng = np.random.default_rng(0)
        sample = torch.from_numpy(rng.uniform(size=tuple(args.shape)).astype(
            np.float32)).to(dev)
        restored = torch.export.load(args.output_file).module()
        with torch.no_grad():
            got, want = restored(sample), live(sample)
        err = float((got - want).abs().max())
        print(f'verify: max |restored - live| = {err:.3e}')
        if not err < 1e-4:
            raise AssertionError('exported program diverges from live model')
        print('The exported program matches the live model.')
        out['max_abs_err'] = err
    return out


if __name__ == '__main__':
    main()
