"""The loader's time to copy one batch to the card: the program's
`loader.upload` spans (PrefetchIterator's worker in loader.device_batch)
over the traced steps, their seconds over their count."""

from portbench import spans


def read(m):
    return spans.mean_ms("loader.upload")
