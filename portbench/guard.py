"""The modules a run of the port must not have loaded.

Names are compared whole, by the part before the first dot, so
``xsmm_tpu_torch`` is not ``xsmm_tpu``.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "xsmm_tpu")


def forbidden_loaded(names: Iterable[str] = ()) -> List[str]:
    """The forbidden top-level names among ``names`` (default: every
    module in ``sys.modules``), sorted."""
    names = list(names) or list(sys.modules)
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))
