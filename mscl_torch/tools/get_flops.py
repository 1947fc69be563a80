"""Parameters and forward FLOPs of a recognizer config.

    python -m mscl_torch.tools.get_flops CONFIG [--shape 1 1 3 16 112 112]
        [--cfg-options ...] [--device cuda|cpu]

Port of ``tools/analysis/get_flops.py`` (reference
tools/analysis/get_flops.py, mmcv's counter). The JAX tool reads XLA's
cost analysis of the compiled inference; here
``torch.utils.flop_counter.FlopCounterMode`` counts one ``forward_test``
on a zero batch of ``--shape``: 2 x the multiply-adds of every
convolution, matmul and attention product, every tap of a convolution
included (those on its zero padding too), and nothing else. XLA counts
only the taps inside the input, and the elementwise work (BN,
activations, pooling, softmax) besides, so the two differ by a few
percent at 224x224 (tests/test_torch_tools.py). The parameter count is
the model's trainable parameters, the JAX tool's ``params`` tree.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..config import Config, DictAction


def count(model, x) -> Dict[str, int]:
    """The model's parameters and the FLOPs of its forward_test on x."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.forward_test(x)
    return dict(params=sum(p.numel() for p in model.parameters()),
                flops=counter.get_total_flops())


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, int]:
    parser = argparse.ArgumentParser(description='Count FLOPs/params')
    parser.add_argument('config')
    parser.add_argument('--shape', type=int, nargs='+',
                        default=[1, 1, 3, 16, 112, 112],
                        help='input batch shape (NCTHW with clip dim)')
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        default={})
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    from ..apis.inference import init_recognizer
    model, cfg = init_recognizer(cfg, None, device=args.device)
    x = torch.zeros(args.shape, device=next(model.parameters()).device)
    out = count(model, x)
    print(f'input shape: {tuple(args.shape)}')
    print(f'params: {out["params"] / 1e6:.2f} M')
    print(f'forward flops (torch FlopCounterMode): '
          f'{out["flops"] / 1e9:.2f} GFLOPs')
    return out


if __name__ == '__main__':
    main()
