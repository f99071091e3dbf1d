"""MNK index utilities — the scripts/libxsmm_utilities.py analog.

Reference build-time specialization takes make keys MNK= / M= N= K= /
THRESHOLD= (Makefile:34-44), expands comma-separated groups into
cross-products, filters by the smallness threshold ((M*N*K)^(1/3) <= 64 by
default), and feeds the generator driver (scripts/libxsmm_utilities.py
load_mnklist).  Here the same surface produces XSMM_AOT_SHAPES specs for
init-time dispatch (xsmm_tpu_torch/__init__.py ``init``) and the generator
CLI.  The port's own copy of ``xsmm_tpu/tools/mnk.py``.

Formats accepted by parse_mnk:
  "MNK": "2 3, 4 5"      -> cross products within each group:
                            (2,2,2),(2,3,2),... and (4,4,4),(4,5,4),...
  "M/N/K": separate axis lists -> full M x N x K product
  "indexes": "2_3_4 5_5_5" -> explicit triples
"""

from __future__ import annotations

import itertools
from typing import Iterable, List, Sequence, Set, Tuple

Triple = Tuple[int, int, int]

DEFAULT_THRESHOLD = 64 ** 3  # (M*N*K)^(1/3) <= 64 (README.md:11)


def _groups(spec: str) -> List[List[int]]:
    return [[int(v) for v in group.split()]
            for group in spec.split(",") if group.strip()]


def parse_mnk(spec: str) -> Set[Triple]:
    """Cross products within each comma-separated group (MNK= semantics)."""
    out: Set[Triple] = set()
    for group in _groups(spec):
        out.update(itertools.product(group, group, group))
    return out


def parse_axes(m_spec: str, n_spec: str = "", k_spec: str = "") -> Set[Triple]:
    """Full M x N x K product from per-axis lists (M=/N=/K= semantics);
    empty axis specs reuse the M list, like the reference make keys."""
    ms = [int(v) for v in m_spec.replace(",", " ").split()]
    ns = [int(v) for v in n_spec.replace(",", " ").split()] or ms
    ks = [int(v) for v in k_spec.replace(",", " ").split()] or ms
    return set(itertools.product(ms, ns, ks))


def parse_indexes(spec: str) -> Set[Triple]:
    """Explicit 'M_N_K' triples separated by whitespace."""
    out: Set[Triple] = set()
    for tok in spec.split():
        m, n, k = (int(v) for v in tok.split("_"))
        out.add((m, n, k))
    return out


def threshold_filter(triples: Iterable[Triple],
                     threshold: int = DEFAULT_THRESHOLD) -> List[Triple]:
    """Keep 'small' triples: M*N*K <= threshold, sorted for determinism."""
    return sorted(t for t in triples if t[0] * t[1] * t[2] <= threshold)


def to_aot_shapes(triples: Iterable[Triple], dtype: str = "",
                  batch: int = 0) -> str:
    """Render triples as an XSMM_AOT_SHAPES value — the init-time parser
    accepts 'MxNxK[:dtype[:batch]]' (xsmm_tpu_torch/__init__.py ``init``)."""
    if batch and not dtype:
        dtype = "float32"
    suffix = (f":{dtype}" if dtype else "") + (f":{batch}" if batch else "")
    return ",".join(f"{m}x{n}x{k}{suffix}"
                    for m, n, k in sorted(set(triples)))
