"""What a `--trace 1` run reads from torch.profiler over its traced span:
the card's kernels by name and time, the span's busy time (the union of
the card's kernels and copies), and the host's work in the card's
longest idle gaps.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple

SPAN_NAME = "portbench.span"


@dataclasses.dataclass
class Summary:
    span_s: float                   # the traced span on the profiler's clock
    busy_s: float                   # union of device activity inside it
    kernels: List[Tuple[str, float]]  # (name, seconds), every device kernel
    idle_gaps: List[Tuple[str, float]]  # (host op, seconds) summed by op, longest first
    steps: int = 0                  # steps in the span

    def kernel_seconds(self, *needles: str) -> float:
        return sum(s for name, s in self.kernels if any(n in name for n in needles))

    def top_ops(self, k: int = 10) -> List[Tuple[str, float]]:
        by: Dict[str, float] = {}
        for name, s in self.kernels:
            by[name] = by.get(name, 0.0) + s
        return sorted(by.items(), key=lambda kv: -kv[1])[:k]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(prof) -> Summary:
    """Read a finished torch.profiler.profile whose traced steps ran
    inside record_function(SPAN_NAME)."""
    from torch.autograd import DeviceType

    events = prof.events()
    span = [e for e in events if e.name == SPAN_NAME and e.device_type == DeviceType.CPU]
    if not span:
        raise RuntimeError("the traced span is missing from the profile")
    lo, hi = span[0].time_range.start, span[0].time_range.end
    device, kernels, host = [], [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if e.name == SPAN_NAME or getattr(e, "is_user_annotation", False):
                continue  # the span's own mark on the card's timeline, not work
            a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
            if b <= a:
                continue
            device.append((a, b))
            low = e.name.lower()
            if "memcpy" not in low and "memset" not in low:
                kernels.append((e.name, (b - a) / 1e6))
        elif e.device_type == DeviceType.CPU and e.name != SPAN_NAME and lo <= e.time_range.start <= hi:
            host.append(e)
    busy = _union(device)
    # the longest idle gaps, each named by the host op that started last before it
    host.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)), reverse=True)
    named: Dict[str, float] = {}
    for length, start in gaps[:500]:
        if length <= 0:
            break
        j = bisect.bisect_right(starts, start + length / 2) - 1
        label = host[j].name if j >= 0 else "(none)"
        named[label] = named.get(label, 0.0) + length / 1e6
    return Summary(span_s=(hi - lo) / 1e6, busy_s=sum(b - a for a, b in busy) / 1e6, kernels=kernels,
                   idle_gaps=sorted(named.items(), key=lambda kv: -kv[1])[:10])
