"""NumpyLoader's ``close``: once it returns, the producer has ended, so the
global ``random`` and ``np.random`` generators are the caller's alone. A
loader read in part and closed (PreciseBN, a test that takes one batch)
must not go on drawing from them while the next test seeds and draws.
And a thread worker's exception reaches the consumer."""
import random
import time

import numpy as np
import pytest

from mscl_torch.datasets.loader import NumpyLoader


class _Drawing:
    """Items whose decode draws from both global generators, slowly, as a
    pipeline's random crops do."""

    def __len__(self):
        return 64

    def __getitem__(self, i):
        time.sleep(0.02)
        return dict(x=np.random.rand(2).astype(np.float32),
                    y=np.float32(random.random()), label=i)


@pytest.mark.parametrize('num_workers', [0, 2])
def test_close_leaves_the_global_generators_alone(num_workers):
    loader = NumpyLoader(_Drawing(), 4, seed=0, num_workers=num_workers,
                         prefetch=2)
    it = iter(loader)
    next(it)
    next(it)
    it.close()
    assert not it._thread.is_alive()
    states = random.getstate(), np.random.get_state()
    time.sleep(0.3)     # a live producer would decode several items here
    assert random.getstate() == states[0]
    np.testing.assert_array_equal(np.random.get_state()[1], states[1][1])
    assert np.random.get_state()[2] == states[1][2]


def test_a_thread_worker_error_reaches_the_consumer():
    """With thread workers, an item's exception is raised by the iterator
    (the first failing slot's), not lost in its worker thread."""
    class Failing(_Drawing):
        def __getitem__(self, i):
            if i in (5, 6):
                raise ValueError(f'item {i}')
            return super().__getitem__(i)
    it = iter(NumpyLoader(Failing(), 4, shuffle=False, num_workers=2))
    next(it)
    with pytest.raises(ValueError, match='item 5'):
        next(it)
    it.close()
