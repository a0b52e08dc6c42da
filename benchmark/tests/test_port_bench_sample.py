"""The window's answers are sampled uniformly and reproducibly from the
seed, with a fixed number held however long the window."""
import collections

from harness.sample import Sample


def test_keeps_everything_up_to_k_then_k():
    s = Sample(3, 7)
    for i in range(2):
        s.offer(i)
    assert s.items == [0, 1]
    for i in range(2, 1000):
        s.offer(i)
    assert len(s.items) == 3 and s.n == 1000


def test_same_seed_same_sample_and_uniform():
    def draw(seed):
        s = Sample(2, seed)
        for i in range(10):
            s.offer(i)
        return tuple(s.items)

    assert draw(2 ** 31 + 5) == draw(2 ** 31 + 5)
    counts = collections.Counter(i for seed in range(4000) for i in draw(seed))
    assert all(650 < counts[i] < 950 for i in range(10))   # 800 each if uniform
