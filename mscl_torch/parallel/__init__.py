"""Data parallelism: one process a card over ``torch.distributed``
(``dist``), and the CLIs' launcher flags (``launch``)."""
from . import dist

__all__ = ['dist']
