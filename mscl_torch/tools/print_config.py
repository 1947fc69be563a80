"""Print the fully resolved config.

    python -m mscl_torch.tools.print_config CONFIG [--cfg-options key=value ...]

Port of ``tools/analysis/print_config.py``: the same text, from the
port's ``Config`` (its bases merged, the options applied).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..config import Config, DictAction


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Prints the config's text and returns it."""
    parser = argparse.ArgumentParser(description='Print a config')
    parser.add_argument('config')
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        default={})
    args = parser.parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    print(cfg.pretty_text)
    return cfg.pretty_text


if __name__ == '__main__':
    main()
