"""The one traffic generator: it reads a traffic file's parameters
(traffic/<name>.json) and makes the inputs of a run from its seed, on the
card, in a few large draws. The same seed gives the same inputs; every
seed gives the same sizes, so the work of a run does not depend on it.

Cached-token batches: the feature-cache layout of the port's
`device_cached_batch` (train/experiments.py): float16 conv4_3-scale
tokens in [0, 40) [B*L, F, C], normalized 8x8 gt heatmaps, (dy, dx)
offsets in [-0.2, 0.2).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.weights import generator


def cached_batches(conf: dict, batch: int, sequence_length: int, pool: int, seed: int,
                   device) -> List[Dict[str, torch.Tensor]]:
    """`pool` distinct batches of B*L frames in the feature-cache layout,
    drawn on `device`."""
    n = batch * sequence_length
    gw = conf["data"]["gt_width"]
    gen = generator(seed, 20, device)
    out = []
    for _ in range(pool):
        gts = torch.rand(n, gw, gw, generator=gen, device=device)
        gts = gts / gts.sum(dim=(1, 2), keepdim=True)
        offs = (torch.rand(2, n, generator=gen, device=device) - 0.5) * 0.4
        feats = torch.rand(n, conf["num_features"], conf["feature_depth"], generator=gen, device=device) * 40
        out.append({"gts": gts, "y_offsets": offs[0].contiguous(), "x_offsets": offs[1].contiguous(),
                    "features": feats.half()})
    return out
