"""The program's span-and-counter registry (`ntm_tracker_tpu_torch.utils.
profiling`), as the per-layer readers (metrics/*.py) see it. A reader
gets None where the program has no registry (a checkout from before it)
or where no span of the name was recorded. The program's spans record in
a thread that torch.profiler records: in a `--trace 1` run the harness's
profiler turns them on in the main thread over the traced steps alone,
so the registry holds those steps.
"""

from __future__ import annotations

from typing import Optional


def registry():
    """The program's profiling module where it has the registry, else None."""
    try:
        from ntm_tracker_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "snapshot") else None


def span(name: str) -> Optional[dict]:
    """{"count", "seconds"} of the program's span `name`, or None."""
    reg = registry()
    if reg is None:
        return None
    found = reg.snapshot()["spans"].get(name)
    return found if found and found["count"] else None


def mean_ms(name: str) -> Optional[float]:
    """The mean milliseconds of the program's span `name`, or None."""
    found = span(name)
    return None if found is None else 1e3 * found["seconds"] / found["count"]
