"""Share of the traced span that the train loop spent waiting for a
batch: the program's `loader.wait` spans (data/loader.py:
PrefetchIterator.__next__) over the span's seconds."""

from portbench import spans


def read(m):
    found = spans.span("loader.wait")
    if found is None or m.trace is None or m.trace.span_s <= 0:
        return None
    return 100.0 * found["seconds"] / m.trace.span_s
