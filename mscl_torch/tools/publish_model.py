"""Strip the optimizer state from a checkpoint and append a content hash.

    python -m mscl_torch.tools.publish_model IN.pth OUT.pth

Port of ``tools/deployment/publish_model.py``: writes
``OUT-<first 8 hex digits of the file's sha256>.pth`` (the model's
weights, buffers and generators, no optimizer state) and prints its path.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..core import publish_model


def main(argv: Optional[Sequence[str]] = None) -> str:
    parser = argparse.ArgumentParser(description='Publish a checkpoint')
    parser.add_argument('in_file')
    parser.add_argument('out_file')
    args = parser.parse_args(argv)
    final = publish_model(args.in_file, args.out_file)
    print(f'published to {final}')
    return final


if __name__ == '__main__':
    main()
