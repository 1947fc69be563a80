"""A picklable toy dataset for the loader's process-worker tests (a
``forkserver`` or ``spawn`` child imports it by name, so it lives in a
module that imports nothing heavy)."""
import numpy as np


class Items:
    """``n`` samples: a 2x2 image full of the index and the index as label;
    ``bad`` is an index whose read raises."""

    def __init__(self, n=10, bad=None):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise ValueError('boom')
        return dict(imgs=np.full((2, 2), i, np.float32), label=i)
