"""The check that no JAX is loaded: the top-level name of every loaded
module (the part before the first dot) compared whole with the forbidden
names. The port's name, `ntm_tracker_tpu_torch`, begins with the JAX
package's, so a test of prefixes would be wrong."""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ntm_tracker_tpu"})


class Forbidden(RuntimeError):
    def __init__(self, names: List[str]):
        super().__init__(f"forbidden modules are loaded: {', '.join(names)}")
        self.names = names


def forbidden_loaded(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among `modules` (default: sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in list(names)} & FORBIDDEN)
