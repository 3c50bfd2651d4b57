"""Share of the traced span in which nothing ran on the card (no kernel,
no copy), from the profiler's trace."""


def read(m):
    t = m.trace
    if t is None or t.span_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.span_s)
