"""Trained frames (B x L a step) over the window's seconds; the window
ends when every step is done and its loss read on the host."""


def read(m):
    return m.work / m.window_s
