"""PyFR's operators of the sparse configurations, made from their definition.

PyFR's ``BaseShape.m0`` (``pyfr/shapes.py``) is the nodal basis of the
solution points evaluated at the flux points: it interpolates a solution
to the element's faces.  For a hex of order p with PyFR's defaults, both
point sets are Gauss-Legendre: the solution points are the tensor product
of the p + 1 one-dimensional nodes, and each face carries the (p + 1)^2
products of the nodes in its two tangential directions.  A flux point then
shares its tangential coordinates with a line of p + 1 solution points, so
its row holds the p + 1 one-dimensional Lagrange basis values at the face's
end (-1 or +1) on that line and zeros elsewhere.
"""

from __future__ import annotations

import numpy as np


def gauss_legendre(n: int) -> np.ndarray:
    """The ``n`` Gauss-Legendre nodes on [-1, 1], ascending."""
    return np.polynomial.legendre.leggauss(n)[0]


def lagrange_at(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """[len(x), len(nodes)]: each Lagrange basis polynomial of ``nodes``
    evaluated at each point of ``x``."""
    x = np.asarray(x, dtype=np.float64)[:, None]
    out = np.ones((x.shape[0], len(nodes)))
    for a, ra in enumerate(nodes):
        for b, rb in enumerate(nodes):
            if a != b:
                out[:, a] *= (x[:, 0] - rb) / (ra - rb)
    return out


def hex_m0(order: int) -> np.ndarray:
    """M0 of a hex of ``order``, dense f64 [6 (p+1)^2, (p+1)^3].

    Rows by face (-x, +x, -y, +y, -z, +z), then by the face's two
    tangential node indices, the lower axis fastest; columns by solution
    point, x fastest."""
    p1 = order + 1
    ends = lagrange_at(gauss_legendre(p1), np.array([-1.0, 1.0]))
    m0 = np.zeros((6 * p1 * p1, p1 ** 3))
    row = 0
    for axis in range(3):
        tangential = [ax for ax in range(3) if ax != axis]
        for side in range(2):
            for t1 in range(p1):
                for t0 in range(p1):
                    for a in range(p1):
                        idx = [0, 0, 0]
                        idx[axis] = a
                        idx[tangential[0]], idx[tangential[1]] = t0, t1
                        col = idx[0] + p1 * (idx[1] + p1 * idx[2])
                        m0[row, col] = ends[side, a]
                    row += 1
    return m0


def operator(spec: dict) -> np.ndarray:
    """The operator a configuration's ``operator`` entry names: ``shape``
    "hex", ``matrix`` "m0", ``order``, and both point sets
    "gauss-legendre"."""
    if (spec["shape"], spec["matrix"], spec["soln_pts"],
            spec["flux_pts"]) != ("hex", "m0", "gauss-legendre",
                                  "gauss-legendre"):
        raise ValueError(f"no operator for {spec}")
    return hex_m0(int(spec["order"]))
