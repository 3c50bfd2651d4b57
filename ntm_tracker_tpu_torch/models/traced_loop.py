"""The recurrent cores' step loops as one loop in an exported program.

torch.export records an eager Python loop one step at a time: the frame
step's 65 NTM cell steps trace to ~6,400 graph nodes, which takes tens of
seconds to export and as long to load. tools/export_serving builds its
core with make_core(cfg, loop=scan_steps), so models/ntm_cell.cell_loop
and models/dnc/dnc.dnc_unroll run their steps through torch's scan
operator (torch._higher_order_ops.scan) instead: the step is recorded
once, the exported program loops over it, and each step runs the same
operations as the eager loop. The live routes keep the eager loop.

The scan's carry is the state's tensors as a flat list (the operator takes
no NamedTuple, the DNC's state), each kept contiguous from step to step
(the clones are exact copies), and the step's weights must reach the traced program as its inputs or buffers
(tools/export_serving.py registers them as buffers), not as constants
closed over by the step.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from ntm_tracker_tpu_torch.train.optim import tree_leaves, tree_map


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


def scan_steps(step: Callable[[torch.Tensor, Any], Tuple[torch.Tensor, Any]], xs: torch.Tensor,
               state: Any) -> Tuple[torch.Tensor, Any]:
    """step(x [B, ...], state) -> (out [B, ...], state), over xs [T, B, ...]
    (time-major): (outs [T, B, ...], final state), as one scan."""
    from torch._higher_order_ops.scan import scan

    def rebuild(leaves):
        it = iter(leaves)
        return tree_map(lambda _: next(it), state)

    def combine(carry, x):
        out, new = step(x, rebuild(carry))
        return [_contiguous(t) for t in tree_leaves(new)], out

    final, outs = scan(combine, [_contiguous(t) for t in tree_leaves(state)], xs)
    return outs, rebuild(final)
