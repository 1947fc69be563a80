"""Data parallelism over ``torch.distributed``: the port of
``mscl_tpu/parallel/mesh.py``.

The JAX package runs one program over a one-axis data-parallel mesh: the
global batch is sharded over the devices, the model and optimizer state are
replicated, and XLA inserts the reductions (gradient psums, BN statistics)
into the jitted step. Here each card runs a process (a rank) that holds a
replica of the state and its own rows of every global batch, and the same
reductions are explicit collectives:

  - every BN in train mode all-reduces ``[sum x, sum x^2, n]``, and its
    backward ``[sum dy, sum dy*xhat]`` (``ops/batch_norm.py``);
  - the MoCo keys are gathered in rank order before the enqueue
    (``models/recognizers/moco.py``);
  - a cross-entropy's denominator is all-reduced
    (``models/losses/cross_entropy_loss.py``);
  - the trainable gradients are mean-all-reduced in flat float32 buckets
    before the global-norm clip (``core/optimizer.py``), and the logged
    values after the step (``core/train_loop.py``);
  - evaluation gathers its rows in rank order (``apis/inference.py``).

So n ranks compute what one device computes on the same global batch, up to
the order of the sums. With no process group every helper here is the
identity and nothing is communicated: a one-card run is the plain path.

Rank r owns rows ``[r*L, (r+1)*L)`` of a global batch of ``n*L`` rows
(``rank_rows``), the order ``all_gather_rows`` puts them back in. Under the
gloo backend a CUDA tensor goes through a host copy; NCCL takes it where it
lies. Each wrapper counts its calls, the bytes it reduces and the host
seconds inside it, by tag (``COLLECTIVES``; ``reset_counts`` sets them to
0), as the kernels' wrappers count their launches.
"""
from __future__ import annotations

import collections
import contextlib
import datetime
import os
import pickle
import signal
import socket
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# collective calls, their payload bytes and the host seconds inside them
# (host copies included, with the wait for the card's queued work that a
# copy implies), by tag: {tag: [calls, bytes, seconds]}
COLLECTIVES: 'collections.defaultdict[str, list]' = \
    collections.defaultdict(lambda: [0, 0, 0.0])
# the gradient buckets' size in float32 elements (64 MB)
BUCKET_ELEMS = 1 << 24
TIMEOUT_S = 1800


def reset_counts() -> None:
    COLLECTIVES.clear()


def counts() -> dict:
    """{tag: {'calls': n, 'bytes': b, 'seconds': s}} since the last
    reset."""
    return {k: dict(calls=v[0], bytes=v[1], seconds=v[2])
            for k, v in COLLECTIVES.items()}


@contextlib.contextmanager
def _counted(tag: str, tensors: Sequence[torch.Tensor]):
    entry = COLLECTIVES[tag]
    entry[0] += 1
    entry[1] += sum(t.numel() * t.element_size() for t in tensors)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        entry[2] += time.perf_counter() - t0


# ------------------------------------------------------------------ group
def is_distributed() -> bool:
    """True whenever a process group exists, a world of 1 included."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def backend() -> Optional[str]:
    return dist.get_backend() if is_distributed() else None


def is_main() -> bool:
    return rank() == 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world: Optional[int] = None, rank_: Optional[int] = None,
                     local_rank: Optional[int] = None, device: str = 'cuda'
                     ) -> torch.device:
    """Join (or make) the process group and return this rank's device.

    Where a launcher (``torchrun``) set ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` and ``MASTER_ADDR``, they are read and ``env://`` is the
    rendezvous; otherwise ``init_method`` (``tcp://host:port``), ``world``
    and ``rank_`` are required. The backend defaults to NCCL for the card
    and gloo for the CPU. On the card the rank takes card ``LOCAL_RANK``
    (modulo the visible cards: several gloo ranks may share one card; NCCL
    refuses that). A collective that waits ``TIMEOUT_S`` for a rank
    fails."""
    env = os.environ
    if init_method is None and 'RANK' in env and 'MASTER_ADDR' in env:
        init_method = 'env://'
        world, rank_ = int(env['WORLD_SIZE']), int(env['RANK'])
        local_rank = int(env.get('LOCAL_RANK', 0))
    if init_method is None or world is None or rank_ is None:
        raise ValueError('init_distributed needs a launcher environment '
                         '(RANK, WORLD_SIZE, MASTER_ADDR) or init_method, '
                         'world and rank_')
    local_rank = rank_ if local_rank is None else local_rank
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device for this rank; pass '
                               "device='cpu' to run the ranks on the CPU")
        dev = torch.device('cuda', local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
    kwargs = dict(device_id=dev) if backend == 'nccl' else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank_,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S),
                            **kwargs)
    return dev


def destroy() -> None:
    if is_distributed():
        dist.destroy_process_group()


def _staged(t: torch.Tensor):
    """(the tensor the backend takes, whether it is a host copy)."""
    if t.is_cuda and dist.get_backend() == 'gloo':
        return t.cpu(), True
    return t, False


# ------------------------------------------------------------ collectives
def rank_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global-batch tensor's leading axis."""
    n = world_size()
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f'a global batch of {x.shape[0]} rows does not '
                         f'divide over {n} ranks')
    per = x.shape[0] // n
    return x[rank() * per:(rank() + 1) * per]


def rank_rows_tree(tree):
    """``rank_rows`` on every tensor of at least one axis in a tree of
    dicts, lists and tuples; 0-d tensors and other leaves as they are."""
    if isinstance(tree, dict):
        return {k: rank_rows_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rank_rows_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dim() >= 1:
        return rank_rows(tree)
    return tree


def all_reduce_(tensors: Sequence[torch.Tensor], op: str = 'sum',
                tag: str = 'all_reduce') -> None:
    """Sum (or mean) each tensor over the ranks, in place, as one flat
    collective (the tensors share a dtype and a device)."""
    if not is_distributed() or not tensors:
        return
    flat = tensors[0].reshape(-1) if len(tensors) == 1 else \
        torch.cat([t.reshape(-1) for t in tensors])
    with _counted(tag, [flat]):
        buf, staged = _staged(flat)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        if staged:
            flat.copy_(buf)
    if op == 'mean':
        flat.div_(world_size())
    elif op != 'sum':
        raise ValueError(op)
    if len(tensors) > 1 or flat.data_ptr() != tensors[0].data_ptr():
        off = 0
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def all_reduce_max(value: int, tag: str = 'flag') -> int:
    """The largest of the ranks' integers."""
    if not is_distributed():
        return value
    t = torch.tensor([value], dtype=torch.int64)
    if dist.get_backend() == 'nccl':
        t = t.cuda()
    with _counted(tag, [t]):
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return int(t.item())


def all_reduce_grads_(grads: Sequence[torch.Tensor],
                      tag: str = 'grad_bucket') -> None:
    """Mean-all-reduce gradients in flat float32 buckets of at most
    ``BUCKET_ELEMS`` elements, in the given order."""
    if not is_distributed():
        return
    bucket, size = [], 0
    for g in grads:
        if bucket and size + g.numel() > BUCKET_ELEMS:
            all_reduce_(bucket, 'mean', tag)
            bucket, size = [], 0
        bucket.append(g)
        size += g.numel()
    all_reduce_(bucket, 'mean', tag)


def all_gather_rows(x: torch.Tensor, tag: str = 'all_gather') -> torch.Tensor:
    """Every rank's x (one shape on all ranks) concatenated along axis 0 in
    rank order."""
    if not is_distributed():
        return x
    x = x.contiguous()
    with _counted(tag, [x]):
        buf, staged = _staged(x)
        parts = [torch.empty_like(buf) for _ in range(world_size())]
        dist.all_gather(parts, buf)
        out = torch.cat(parts)
        return out.to(x.device) if staged else out


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0,
               tag: str = 'broadcast') -> None:
    """Rank src's values into each tensor, in place, one collective a
    tensor."""
    if not is_distributed():
        return
    for t in tensors:
        with _counted(tag, [t]):
            buf, staged = _staged(t)
            dist.broadcast(buf, src)
            if staged:
                t.copy_(buf)


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank src's picklable object, on every rank."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def barrier() -> None:
    if is_distributed():
        if dist.get_backend() == 'nccl':
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


# ------------------------------------------------------------------ spawn
def _rank_main(local_rank, fn, first_rank, world, local_ranks, init_method,
               backend, device, args, results):
    """A spawned rank: join the group, run fn(*args), send back the value
    as plain pickle bytes (torch's queue pickler would share its tensors
    through file descriptors of a process that is about to exit), leave
    the group."""
    if torch.device(device).type == 'cpu':    # the cores split over ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_ranks))
    init_distributed(backend, init_method, world, first_rank + local_rank,
                     local_rank, device)
    try:
        value = fn(*args)
    finally:
        destroy()
    results.put((local_rank, pickle.dumps(value)))


def spawn(fn: Callable, num_ranks: int, args: tuple = (),
          backend: Optional[str] = None, device: str = 'cuda',
          init_method: Optional[str] = None, world: Optional[int] = None,
          first_rank: int = 0, join_timeout_s: Optional[float] = None
          ) -> List[Any]:
    """Run ``fn(*args)`` in ``num_ranks`` new processes
    (``torch.multiprocessing`` with the ``spawn`` start method: a forked
    child cannot use CUDA), each a rank of one group: local rank i is rank
    ``first_rank + i`` of ``world`` (default ``num_ranks``), meeting at
    ``init_method`` (default a free localhost port). Returns each local
    rank's return value in order. A rank that raises stops them all and
    this raises RuntimeError naming every rank that failed; a rank that
    exits with a code (SIGTERM's 143) makes this raise SystemExit with it;
    ranks still running after ``join_timeout_s`` are stopped and this
    raises TimeoutError. A SIGTERM to this process is passed on to the
    ranks."""
    import torch.multiprocessing as mp
    world = num_ranks if world is None else world
    if init_method is None:
        init_method = f'tcp://127.0.0.1:{free_port()}'
    results = mp.get_context('spawn').SimpleQueue()
    context = mp.start_processes(
        _rank_main, (fn, first_rank, world, num_ranks, init_method, backend,
                     device, args, results),
        nprocs=num_ranks, join=False, start_method='spawn')
    previous = None
    if threading.current_thread() is threading.main_thread():
        def forward(signum, frame):
            for p in context.processes:
                if p.is_alive():
                    os.kill(p.pid, signum)
        previous = signal.signal(signal.SIGTERM, forward)
    out = {}

    def drain():      # a rank blocks on a value larger than the pipe
        while not results.empty():
            i, value = results.get()
            out[i] = pickle.loads(value)

    deadline = None if join_timeout_s is None else \
        time.monotonic() + join_timeout_s
    try:
        while not context.join(timeout=0.5):
            drain()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f'ranks still running after '
                                   f'{join_timeout_s} s')
        drain()
    except mp.ProcessRaisedException as e:
        failed = [f'rank {first_rank + i} failed:\n{_error(f)}'
                  for i, f in enumerate(context.error_files)
                  if os.path.exists(f)]
        raise RuntimeError('\n'.join(failed)) from e
    except mp.ProcessExitedException as e:
        if e.exit_code > 0:
            raise SystemExit(e.exit_code) from e
        raise
    finally:
        for p in context.processes:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
            p.join()
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    return [out.get(i) for i in range(num_ranks)]


def _error(path: str) -> str:
    """A rank's traceback, from the file ``torch.multiprocessing`` wrote."""
    with open(path, 'rb') as f:
        text = pickle.load(f)
    os.remove(path)
    return text
