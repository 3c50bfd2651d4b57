"""Seconds from the process's start to the first timed step: imports,
weights and traffic made on the card, kernels loaded (built on a
checkout's first run), the program's set-up and the warm-up steps."""


def read(m):
    return m.setup_s
