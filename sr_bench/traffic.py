"""The one traffic generator: it reads a mix's parameters
(``mixes/<mix>.json``) and makes each request's input from the seed.

A mix lists its LR shapes, each with a ``weight``: the requests cycle
through a schedule that holds each shape ``weight`` times, shuffled anew
each cycle by the cycle's number alone. So every seed sends the same sizes
in the same order, and the work of a window, the program's shape caches'
hits and misses with it, does not hang on the seed. Request i's image is
float32 RGB in [0, 1], drawn on the host from (seed, i) as a decoded image
would arrive; the same seed gives the same inputs.
``tile`` is the tile plan the cell's runner uses (absent: whole image).
How the requests are sent (``loop``, ``callers``) is the mix's driver's
(``drivers/<driver>.py``).
"""

from __future__ import annotations

import numpy as np

# the streams of the warm-up images and of the schedule, apart from the
# requests'
WARM_STREAM = 2 ** 40
SCHEDULE_STREAM = 2 ** 42


class Traffic:
    def __init__(self, mix: dict, seed: int):
        self.seed = seed % (2 ** 63)
        self.tile = mix.get("tile")
        self.slots = [tuple(s["lr"]) for s in mix["shapes"]
                      for _ in range(s.get("weight", 1))]
        self._cycles: dict = {}

    def shape(self, i: int) -> tuple:
        """(h, w) of request i."""
        cycle, pos = divmod(i, len(self.slots))
        if cycle not in self._cycles:
            rng = np.random.default_rng([SCHEDULE_STREAM, cycle])
            self._cycles[cycle] = rng.permutation(len(self.slots))
        return self.slots[self._cycles[cycle][pos]]

    def image(self, i: int) -> np.ndarray:
        """(h, w, 3) float32 input of request i."""
        return self.image_of(self.shape(i), i)

    def image_of(self, shape: tuple, key: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, key])
        return rng.random((*shape, 3), dtype=np.float32)

    def warm_inputs(self) -> list:
        """One input of every shape the mix sends, in a fixed order."""
        return [self.image_of(s, WARM_STREAM + k)
                for k, s in enumerate(sorted(set(self.slots)))]
