"""obs.clock — the ONE timebase every subsystem stamps time with.

Before this module the runtime mixed clocks: the executor stamped
``time.perf_counter`` while the serving layer stamped ``time.monotonic``,
so a span recorded by a worker loop and a latency recorded by a batcher
were not comparable on one axis. Everything now routes through
``clock.now()`` — monotonic, highest resolution available — and the
exporters translate to microseconds relative to ``EPOCH`` (captured at
import, i.e. before any span can exist), which is what Chrome/Perfetto
trace-event ``ts`` fields want.
"""
from __future__ import annotations

import time

# perf_counter is monotonic AND sub-microsecond; monotonic() is only
# guaranteed millisecond-ish on some platforms. Bound as a module-level
# alias so the hot paths pay one global load, no wrapper frame.
now = time.perf_counter

# zero point for exported timestamps (all spans happen after import)
EPOCH = now()


def to_us(t: float) -> float:
    """A ``now()`` timestamp as microseconds since ``EPOCH``."""
    return (t - EPOCH) * 1e6
