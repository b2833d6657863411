"""Where the CUDA kernels' builds live (the restart half of build amortization).

Port of ``cruise_control_tpu/core/compile_cache.py``.  The JAX package points
JAX's persistent compilation cache at ``compile.cache.dir`` so a restarted
server deserializes its compiled programs.  The port has no compile step: its
only builds are the ``nvcc`` runs of ``ops/_build.py``, one shared library
for each CUDA source, named by a digest of the source and the flags.  So the
counterpart points ``_build.BUILD_DIR`` at the directory: a restarted server
loads the libraries it built instead of running ``nvcc`` again.  With no
directory given the default, ``build/kernels/`` beside the checkout, stays.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from cruise_control_tpu_torch.ops import _build


def configure_compile_cache(path: Optional[str] = None) -> Optional[str]:
    """Build and load the kernels' libraries under ``path`` from now on.

    Returns the directory in use, or None when ``path`` is empty (the
    default directory stays).  A library already loaded in this process stays
    loaded; the next build of another source goes to ``path``."""
    if not path:
        return None
    path = os.path.expanduser(path)
    os.makedirs(path, exist_ok=True)
    _build.BUILD_DIR = Path(path)
    return path
