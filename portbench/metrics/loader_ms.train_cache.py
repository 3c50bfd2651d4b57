"""The loader's time to make one host batch: the program's `loader.read`
spans (PrefetchIterator's worker waiting on token_batch_iterator: the
cache's `.npy` reads, the frame records, the stack) over the traced
steps, their seconds over their count."""

from portbench import spans


def read(m):
    return spans.mean_ms("loader.read")
