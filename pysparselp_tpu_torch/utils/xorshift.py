# Verbatim copy of pysparselp_tpu/utils/xorshift.py
"""Language-portable deterministic RNG (xorshift128 + Box–Muller).

Capability parity with the reference's cross-language reproducibility RNG
(``pysparselp/xorshift.py:18-72``): the same integer sequence can be generated
from Matlab/C++ for bit-identical test fixtures.  The state recurrence is
inherently sequential, so ``rand`` fills arrays with a scalar loop exactly
like the reference — bit-identical sequences matter more than speed here.
"""

from __future__ import annotations

import numpy as np

_MASK = 0xFFFFFFFF


class XorShift:
    """xorshift128 with Box–Muller normal sampling."""

    def __init__(self, x=123456789, y=362436069, z=521288629, w=88675123):
        self.x, self.y, self.z, self.w = x, y, z, w
        self.max = 2**32

    def next_value(self) -> int:
        t = self.x ^ (self.x << 11) & _MASK
        self.x, self.y, self.z = self.y, self.z, self.w
        w = self.w
        self.w = w ^ (w >> 19) ^ (t ^ (t >> 8)) & _MASK
        return self.w

    def rand(self, m=1, n=1) -> np.ndarray:
        out = np.empty((m, n))
        flat = out.ravel()
        for i in range(flat.size):
            flat[i] = self.next_value() / self.max
        return out

    def randint(self, a, b) -> int:
        return int(a + (b - a + 1) * self.rand()[0, 0])

    def choice(self, elements):
        return elements[self.randint(0, len(elements) - 1)]

    def randn(self, m=1, n=1) -> np.ndarray:
        return self.normal(0.0, 1.0, m=m, n=n)

    def normal(self, mean, std, m=1, n=1) -> np.ndarray:
        u1 = self.rand(m, n)
        u2 = self.rand(m, n)
        return mean + std * np.sqrt(-2 * np.log(u1)) * np.cos(2 * np.pi * u2)
