"""Evaluate a checkpoint on a config's test set, data-parallel over the
cards.

    python -m mscl_torch.tools.test CONFIG CHECKPOINT
        [--metrics top_k_accuracy mean_class_accuracy ...] [--out JSON]
        [--cfg-options key=value ...] [--device cuda|cpu]
        [--num-devices N] [--coordinator ...]

Port of ``tools/test.py`` (reference mmaction tools/test.py): build the
test set (``data.test``, test mode) and its loader, the model from the
config with the checkpoint's weights (the port's ``epoch_N.pth`` or a
reference ``.pth``), each video's scores, then ``dataset.evaluate``. Prints
the metrics as JSON (and writes them to ``--out``). The loader decodes on
the config's ``workers_per_gpu`` threads: the test pipeline draws nothing,
so the scores do not depend on them. The multi-device flags are the JAX
tool's (``parallel/launch.py``): each rank scores its rows of each global
batch, the scores come back in dataset order on every rank, and rank 0
evaluates, prints and writes them.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from ..config import Config, DictAction
from ..parallel import dist, launch


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='Test a recognizer')
    parser.add_argument('config')
    parser.add_argument('checkpoint')
    parser.add_argument('--metrics', nargs='+',
                        default=['top_k_accuracy', 'mean_class_accuracy'])
    parser.add_argument('--out', help='output result json')
    launch.add_arguments(parser)
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        default={})
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)
    launch.check(parser, args)
    return args


def build_test_loader(cfg, split: str):
    """The split's dataset in test mode and an in-order loader over it (the
    rank's rows of each global batch, the last one padded)."""
    from ..apis.train import _plain
    from ..datasets import build_dataloader, build_dataset
    ds_cfg = _plain(cfg.data[split])
    ds_cfg['test_mode'] = True
    dataset = build_dataset(ds_cfg)
    loader = build_dataloader(
        dataset, videos_per_gpu=cfg.data['videos_per_gpu'],
        workers_per_gpu=cfg.data.get('workers_per_gpu', 0), shuffle=False,
        num_gpus=dist.world_size(), rank=dist.rank(), pad_last=True)
    return dataset, loader


def main(argv: Optional[Sequence[str]] = None):
    """Returns the metrics."""
    args = parse_args(argv)
    return launch.run(_test, args, args)


def _test(args):
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)

    from ..apis.inference import init_recognizer, run_test
    model, cfg = init_recognizer(cfg, args.checkpoint, device=args.device)
    dataset, loader = build_test_loader(cfg, 'test')
    try:
        results = run_test(model, loader)
    finally:
        loader.shutdown()
    metrics = None
    if dist.is_main():
        metrics = {k: float(v) for k, v in
                   dataset.evaluate(results, metrics=args.metrics).items()}
        print(json.dumps(metrics, indent=2))
        if args.out:
            with open(args.out, 'w') as f:
                json.dump(metrics, f)
    return dist.broadcast_object(metrics)


if __name__ == '__main__':
    main()
