"""Wall-clock phase timing (reference: SimpleTimer, DCORA_utils.h:35-60,
DCORA_utils.cpp:127-145) plus a per-phase accumulator matching the Graph's
ms_construct_Q_/G_/precon_ bookkeeping (Graph.h:468-471).

On-device work is asynchronous under JAX; ``SimpleTimer`` therefore blocks
on a pytree of arrays at ``toc`` when one is supplied, so timings measure
completed device work rather than dispatch.
"""

from __future__ import annotations

import subprocess
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional


def _block(arrays) -> None:
    if arrays is None:
        return
    import jax

    jax.block_until_ready(arrays)


class SimpleTimer:
    """tic/toc in milliseconds (reference: SimpleTimer)."""

    def __init__(self):
        self._t0: Optional[float] = None

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self, block_on=None) -> float:
        """Elapsed ms since tic(); optionally blocks on device arrays."""
        assert self._t0 is not None, "toc() before tic()"
        _block(block_on)
        ms = (time.perf_counter() - self._t0) * 1e3
        self._t0 = None
        return ms


class PhaseTimer:
    """Accumulates wall-clock per named phase.

    >>> pt = PhaseTimer()
    >>> with pt.phase("construct_Q"):
    ...     ...
    >>> pt.ms["construct_Q"]
    """

    def __init__(self):
        self.ms: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _block(block_on)
            self.ms[name] += (time.perf_counter() - t0) * 1e3
            self.count[name] += 1

    def report(self) -> str:
        lines = [
            f"{name}: {self.ms[name]:.1f} ms / {self.count[name]} calls"
            for name in sorted(self.ms)
        ]
        return "\n".join(lines)


def device_loop_seconds(fn, X, reps: int = 50) -> float:
    """Seconds per call of ``fn`` on device, timed inside one jitted
    fori_loop so that host dispatch is not counted.  ``fn`` maps X (an
    array or pytree) to a value of the same structure, shapes and dtypes;
    the loop feeds each output back in scaled by 0.999, which keeps the
    data dependency between calls (the values may overflow; the work per
    call does not change).  The cost of a 2-trip loop is subtracted, and
    the first call compiles."""
    import jax

    def body(i, Y):
        return jax.tree.map(lambda a: a * 0.999, fn(Y))

    @jax.jit
    def loop(X, n):
        return jax.lax.fori_loop(0, n, body, X)

    jax.block_until_ready(loop(X, 2))
    t0 = time.perf_counter()
    jax.block_until_ready(loop(X, 2))
    base = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(loop(X, reps + 2))
    return (time.perf_counter() - t0 - base) / reps


def gpu_name_and_power_limit() -> str:
    """What `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints: one "name, limit" line per card.  Raises when nvidia-smi is
    missing or fails, so no number is reported without its card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
