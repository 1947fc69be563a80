"""The CLIs' data-parallel flags, those of the JAX tools, and the launch.

    --num-devices N    N local ranks, one a card (default: one a visible
                       card, as the JAX mesh takes every chip; with
                       --device cpu, N gloo ranks on the CPU, the
                       counterpart of JAX's forced host devices)
    --coordinator host:port --num-hosts H --host-id i
                       H hosts of N local ranks each: world H x N, rank
                       i x N + local rank, meeting at host:port

The collectives go over NCCL on the cards, one rank a card, and over gloo
on the CPU, or where there are more local ranks than visible cards and
they must share them (NCCL refuses two ranks on one card).

A process started by ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
and ``MASTER_ADDR`` set) joins the group torchrun made. One local rank on
one host, with no launcher, runs with no process group: the one-card path.
"""
from __future__ import annotations

import os
import sys
from typing import Any, Callable

import torch

from . import dist


def add_arguments(parser) -> None:
    parser.add_argument('--num-devices', type=int, default=None,
                        help='local ranks, one a card (default: every '
                             'visible card)')
    parser.add_argument('--coordinator', default=None,
                        help='multi-host rendezvous address host:port')
    parser.add_argument('--num-hosts', type=int, default=None)
    parser.add_argument('--host-id', type=int, default=None)


def check(parser, args) -> None:
    """Refuse flags that cannot make a group (argparse's exit code 2)."""
    if args.num_devices is not None and args.num_devices < 1:
        parser.error(f'--num-devices must be at least 1, got '
                     f'{args.num_devices}')
    multi = (args.coordinator, args.num_hosts, args.host_id)
    if any(v is not None for v in multi) and \
            not all(v is not None for v in multi):
        parser.error('--coordinator, --num-hosts and --host-id go together')
    if args.num_hosts is not None and \
            not 0 <= args.host_id < args.num_hosts:
        parser.error(f'--host-id {args.host_id} is not in '
                     f'[0, {args.num_hosts})')


def _launcher_env() -> bool:
    return all(k in os.environ for k in ('RANK', 'WORLD_SIZE',
                                         'MASTER_ADDR'))


def run(fn: Callable, args, *fn_args) -> Any:
    """``fn(*fn_args)`` on every local rank of the group the flags describe
    (or in this process, with no group, for one rank); returns local rank
    0's result."""
    if _launcher_env():
        dist.init_distributed(device=args.device)
        try:
            return fn(*fn_args)
        finally:
            dist.destroy()
    on_card = torch.device(args.device).type == 'cuda'
    cards = torch.cuda.device_count() if on_card else 0
    local = args.num_devices or (max(cards, 1) if on_card else 1)
    hosts = args.num_hosts or 1
    if local == 1 and hosts == 1:
        return fn(*fn_args)
    if on_card and not cards:
        raise SystemExit('no visible cards for the ranks (--device cpu runs '
                         'them on the CPU)')
    backend = 'nccl' if on_card and local <= cards else 'gloo'
    if on_card and backend == 'gloo':
        print(f'{local} ranks share {cards} card(s): the collectives go '
              f'over gloo', file=sys.stderr)
    init = f'tcp://{args.coordinator}' if args.coordinator else None
    return dist.spawn(fn, local, fn_args, backend=backend,
                      device=args.device, init_method=init,
                      world=hosts * local,
                      first_rank=(args.host_id or 0) * local)[0]
