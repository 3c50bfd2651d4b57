"""The whole train step's share of the card's float32 peak:
portbench/counts.train_step_flops a step over the window's time."""

from portbench import counts


def read(m):
    if m.card is None or m.window_s <= 0:
        return None
    tr = m.run.traffic
    B, L = tr["batch"], tr["sequence_length"]
    steps = m.work / (B * L)
    return 100.0 * counts.train_step_flops(m.run.conf, B, L) * steps / m.window_s / m.card["float32"]
