"""What a run may load: neither JAX nor the JAX package.

The port's package is ``cruise_control_tpu_torch``, whose name begins with the
JAX package's, ``cruise_control_tpu``; so modules are compared by their
top-level name (the part before the first dot), whole.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "cruise_control_tpu")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules (``sys.modules`` unless ``names`` is given) whose
    top-level name is forbidden, sorted."""
    names = sys.modules.keys() if names is None else names
    return sorted({n for n in names if top_level(n) in FORBIDDEN})
