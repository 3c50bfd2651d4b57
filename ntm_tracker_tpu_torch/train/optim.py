"""The reference's optimizer with TF-1.x semantics (counterpart of
ntm_tracker_tpu/train/optim.py).

The reference trains with tf.train.RMSPropOptimizer(lr, decay, momentum)
after tf.clip_by_global_norm (direct_offset_output.py:611-626):

    g   <- (g / ||g||) * max_norm    unless ||g|| < max_norm (optax's rule,
                                      selected on the device)
    ms  <- decay * ms + (1 - decay) * g^2        ms starts at ONES, as in TF
    mom <- momentum * mom + lr * g / sqrt(ms + eps)      eps INSIDE the sqrt
    p   <- p - mom

torch.optim.RMSprop starts ms at zeros and adds eps outside the sqrt, and
clip_grad_norm_ divides by norm + 1e-6, so neither is used. The update is
functional over the params tree (a dict whose "controller" is a list of
per-layer dicts; the DNC's also nests its "access" dict): the state
{"ms", "mom"} is a pair of trees of the same shape, so a checkpoint of
{"params", "opt_state"} holds both.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Map fn over the tensor leaves of nested dicts, lists, tuples and
    NamedTuples (the DNC's state, rebuilt from its fields)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        children = [tree_map(fn, v, *[r[i] for r in rest]) for i, v in enumerate(tree)]
        return type(tree)(*children) if hasattr(tree, "_fields") else type(tree)(children)
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(tree)))


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tree:
    """optax.clip_by_global_norm: (g / norm) * max_norm, unless the global
    norm is below max_norm. Selected on the device, leaf by leaf, as optax
    does (no host sync; a NaN norm clips, and so gives NaN)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return tree_map(lambda g: torch.where(keep, g, (g / norm) * max_norm), grads)


@dataclasses.dataclass(frozen=True)
class TFRMSProp:
    """Exact tf.train.RMSPropOptimizer (centered=False), optionally after
    clip_by_global_norm (max_gradient_norm=None: no clipping)."""

    learning_rate: float
    decay: float = 0.9
    momentum: float = 0.0
    epsilon: float = 1e-10
    max_gradient_norm: float | None = None

    def init(self, params: Tree) -> Dict[str, Tree]:
        return {
            "ms": tree_map(lambda p: torch.ones_like(p).detach(), params),
            "mom": tree_map(lambda p: torch.zeros_like(p).detach(), params),
        }

    @torch.no_grad()
    def update(self, grads: Tree, state: Dict[str, Tree], params: Tree):
        """-> (new params, new state); nothing is modified in place."""
        if self.max_gradient_norm is not None:
            grads = clip_by_global_norm(grads, self.max_gradient_norm)
        d, m, lr, eps = self.decay, self.momentum, self.learning_rate, self.epsilon
        ms = tree_map(lambda s, g: d * s + (1 - d) * (g * g), state["ms"], grads)
        mom = tree_map(lambda v, s, g: m * v + lr * g * torch.rsqrt(s + eps), state["mom"], ms, grads)
        new_params = tree_map(lambda p, v: p - v, params, mom)
        return new_params, {"ms": ms, "mom": mom}


def tf_rmsprop(learning_rate: float, decay: float = 0.9, momentum: float = 0.0,
               epsilon: float = 1e-10) -> TFRMSProp:
    """tf.train.RMSPropOptimizer without clipping."""
    return TFRMSProp(learning_rate, decay, momentum, epsilon)


def reference_optimizer(learning_rate: float = 1e-4, decay: float = 0.95, momentum: float = 0.9,
                        epsilon: float = 1e-10, max_gradient_norm: float = 5.0) -> TFRMSProp:
    """clip_by_global_norm -> TF RMSProp, the reference's exact chain."""
    return TFRMSProp(learning_rate, decay, momentum, epsilon, max_gradient_norm)
