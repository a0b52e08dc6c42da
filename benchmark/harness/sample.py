"""A uniform sample of a window's answers, drawn from the seed as they
come (reservoir sampling), so that a run holds a fixed number of answers
however long its window."""
from __future__ import annotations

import random


class Sample:
    def __init__(self, k: int, seed: int):
        self.k, self.n, self.items = k, 0, []
        self._rng = random.Random(seed)

    def offer(self, item) -> None:
        if self.n < self.k:
            self.items.append(item)
        else:
            j = self._rng.randrange(self.n + 1)
            if j < self.k:
                self.items[j] = item
        self.n += 1

    def clear(self) -> None:
        self.n, self.items = 0, []
