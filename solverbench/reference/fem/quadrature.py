# Frozen copy of porotpu_torch/fem/quadrature.py, the benchmark reference's own: later changes to the port do not reach it.
"""Quadrature rules on reference simplices (and their facets).

Replaces the quadrature embedded in FFC-generated element kernels
(reference: implicit in every ``assemble`` call, lib/Assembler.py:97).
Rules are exact for the polynomial degrees needed by the P2/P2/P1
poromechanics forms (mass of two P2 functions = degree 4).

Points are in reference-simplex coordinates; weights sum to the reference
volume (1/2 triangle, 1/6 tet, 1 interval/facet-triangle scaled by detJ
at assembly time).
"""

from __future__ import annotations

import numpy as np


def _gauss01(n: int, alpha: int):
    """Gauss-Jacobi nodes/weights on [0, 1] for the weight (1-u)^alpha.

    Exact for integrand polynomials of degree <= 2n - 1.  Used by the
    collapsed (Duffy/conical-product) simplex rules below, which cover
    arbitrary degree — the tabulated Dunavant/Keast rules handle the
    common degree <= 4 cases with fewer points.
    """
    from scipy.special import roots_jacobi

    t, w = roots_jacobi(n, alpha, 0.0)
    # map [-1,1] -> [0,1]: (1-x)^alpha dx = (2(1-u))^alpha 2 du
    return 0.5 * (t + 1.0), w / 2.0 ** (alpha + 1)


def _collapsed_rule(dim: int, degree: int):
    """Conical-product rule on the reference simplex, exact for total
    degree ``degree`` (degree//2 + 1 points per direction)."""
    n = degree // 2 + 1
    if dim == 2:
        # x = u1, y = u2 (1 - u1); J = (1 - u1)
        u1, w1 = _gauss01(n, 1)
        u2, w2 = _gauss01(n, 0)
        x = u1[:, None] + 0.0 * u2[None, :]
        y = u2[None, :] * (1.0 - u1[:, None])
        w = w1[:, None] * w2[None, :]
        pts = np.stack([x.ravel(), y.ravel()], axis=1)
        return pts, w.ravel()
    # x = u1, y = u2(1-u1), z = u3(1-u1)(1-u2); J = (1-u1)^2 (1-u2)
    u1, w1 = _gauss01(n, 2)
    u2, w2 = _gauss01(n, 1)
    u3, w3 = _gauss01(n, 0)
    X = u1[:, None, None] + 0.0 * (u2[None, :, None] + u3[None, None, :])
    Y = u2[None, :, None] * (1.0 - u1[:, None, None]) + 0.0 * u3[None, None, :]
    Z = (
        u3[None, None, :]
        * (1.0 - u1[:, None, None])
        * (1.0 - u2[None, :, None])
    )
    W = w1[:, None, None] * w2[None, :, None] * w3[None, None, :]
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    return pts, W.ravel()


def _tri_rule(degree: int):
    if degree > 4:
        # collapsed rule already includes the 1/2 volume factor via the
        # Jacobian weights (sum w = 1/2)
        return _collapsed_rule(2, degree)
    if degree <= 2:
        # 3-point edge-midpoint rule, exact degree 2
        pts = np.array([[0.5, 0.0], [0.5, 0.5], [0.0, 0.5]])
        wts = np.full(3, 1.0 / 3.0)
    else:
        # 6-point Dunavant rule, exact degree 4
        a1, b1, w1 = 0.816847572980459, 0.091576213509771, 0.109951743655322
        a2, b2, w2 = 0.108103018168070, 0.445948490915965, 0.223381589678011
        bary = np.array(
            [
                [a1, b1, b1],
                [b1, a1, b1],
                [b1, b1, a1],
                [a2, b2, b2],
                [b2, a2, b2],
                [b2, b2, a2],
            ]
        )
        pts = bary[:, 1:]  # (lambda1, lambda2) = (x, y)
        wts = np.array([w1, w1, w1, w2, w2, w2])
    return pts, wts * 0.5  # reference triangle area = 1/2


def _tet_rule(degree: int):
    if degree > 4:
        return _collapsed_rule(3, degree)
    if degree <= 2:
        a, b = 0.585410196624969, 0.138196601125011
        pts = np.array(
            [
                [a, b, b],
                [b, a, b],
                [b, b, a],
                [b, b, b],
            ]
        )
        wts = np.full(4, 0.25)
    else:
        # Keast 14-point rule, exact degree 4 (verified in tests)
        a1 = 0.3108859192633005
        c1 = 1.0 - 3.0 * a1
        w1 = 0.1126879257180162
        a2 = 0.09273525031089123
        c2 = 1.0 - 3.0 * a2
        w2 = 0.0734930431163619
        b3 = 0.0455037041256496
        d3 = 0.5 - b3
        w3 = 0.0425460207770812

        def perms4(a, c):
            return [
                [a, a, a],
                [a, a, c],
                [a, c, a],
                [c, a, a],
            ]

        # 6 permutations of (b,b,d,d) barycentric
        bary6 = [
            [b3, b3, d3, d3],
            [b3, d3, b3, d3],
            [b3, d3, d3, b3],
            [d3, b3, b3, d3],
            [d3, b3, d3, b3],
            [d3, d3, b3, b3],
        ]
        pts = []
        wts = []
        # barycentric (l0,l1,l2,l3); reference coords = (l1,l2,l3)
        for a, c, w in ((a1, c1, w1), (a2, c2, w2)):
            for p in [[a, a, a, c], [a, a, c, a], [a, c, a, a], [c, a, a, a]]:
                pts.append(p[1:])
                wts.append(w)
        for p in bary6:
            pts.append(p[1:])
            wts.append(w3)
        pts = np.array(pts)
        wts = np.array(wts)
    return pts, wts / 6.0  # reference tet volume = 1/6


def simplex_rule(dim: int, degree: int):
    """Quadrature rule on the reference simplex of dimension ``dim``.

    Returns (points (nq, dim), weights (nq,)); weights include the reference
    volume factor so that sum(w) = |ref simplex|.
    """
    if dim == 2:
        return _tri_rule(degree)
    if dim == 3:
        return _tet_rule(degree)
    raise ValueError(f"unsupported dim {dim}")


def facet_rule(dim: int, degree: int):
    """Rule on the reference facet: interval [0,1] (dim=2) or ref triangle (dim=3)."""
    if dim == 2:
        # Gauss-Legendre on [0,1]
        n = max(2, (degree + 2) // 2)
        x, w = np.polynomial.legendre.leggauss(n)
        return (0.5 * (x + 1.0))[:, None], 0.5 * w
    if dim == 3:
        return _tri_rule(degree)
    raise ValueError(f"unsupported dim {dim}")
