"""Hermite / exponential / linear interpolation polynomial fitting
(reference: src/main/misc/interpolation.cpp).

Used by every dynamics knee: compressor/gate/limiter knees are Hermite
polynomials fitted in log-log space (reference Compressor.cpp:121-128,
Gate.cpp:188-195, Limiter.cpp:463).  Host-side float64 design math.
"""

from __future__ import annotations

import numpy as np


def hermite_quadratic(x0, y0, k0, x1, k1) -> np.ndarray:
    """Quadratic y = p0 x^2 + p1 x + p2 through (x0,y0) with slopes k0@x0,
    k1@x1 (reference interpolation.cpp hermite_quadratic)."""
    p0 = (k0 - k1) * 0.5 / (x0 - x1)
    p1 = k0 - 2.0 * p0 * x0
    p2 = y0 - (p0 * x0 + p1) * x0
    return np.array([p0, p1, p2], np.float64)


def hermite_cubic(x0, y0, k0, x1, y1, k1) -> np.ndarray:
    """Cubic through (x0,y0),(x1,y1) with slopes k0,k1."""
    dx = x1 - x0
    dy = y1 - y0
    kx = dy / dx
    xx1 = x1 * x1
    xx2 = x0 + x1
    a = ((k0 + k1) * dx - 2.0 * dy) / (dx ** 3)
    b = ((kx - k0) + a * ((2.0 * x0 - x1) * x0 - xx1)) / dx
    c = kx - a * (xx1 + xx2 * x0) - b * xx2
    d = y0 - x0 * (c + x0 * (b + x0 * a))
    return np.array([a, b, c, d], np.float64)


def hermite_quadro(x0, y0, k0, x1, y1, k1, x2, y2) -> np.ndarray:
    """Quartic through three points with two slopes (linear solve)."""
    A = np.zeros((5, 5))
    rhs = np.zeros(5)
    X = [x0, x1, x2]
    Y = [y0, y1, y2]
    K = [k0, k1]
    for i, x in enumerate(X):
        A[i] = [x ** 4, x ** 3, x ** 2, x, 1.0]
        rhs[i] = Y[i]
    for i, x in enumerate(X[:2]):
        A[i + 3] = [4 * x ** 3, 3 * x ** 2, 2 * x, 1.0, 0.0]
        rhs[i + 3] = K[i]
    return np.linalg.solve(A, rhs)


def hermite_penta(x0, y0, k0, x1, y1, k1, x2, y2, k2) -> np.ndarray:
    """Quintic through three points with three slopes."""
    A = np.zeros((6, 6))
    rhs = np.zeros(6)
    X = [x0, x1, x2]
    Y = [y0, y1, y2]
    K = [k0, k1, k2]
    for i, x in enumerate(X):
        A[i] = [x ** 5, x ** 4, x ** 3, x ** 2, x, 1.0]
        rhs[i] = Y[i]
        A[i + 3] = [5 * x ** 4, 4 * x ** 3, 3 * x ** 2, 2 * x, 1.0, 0.0]
        rhs[i + 3] = K[i]
    return np.linalg.solve(A, rhs)


def exponent(x0, y0, x1, y1, k) -> np.ndarray:
    """Exponential y = p0 + p1 * exp(p2 x) through two points with rate k."""
    e = np.exp(k * (x0 - x1))
    p0 = (y0 - e * y1) / (1.0 - e)
    p1 = (y0 - p0) / np.exp(k * x0)
    return np.array([p0, p1, k], np.float64)


def linear(x0, y0, x1, y1) -> np.ndarray:
    """Line y = p0 x + p1 through two points."""
    k = (y1 - y0) / (x1 - x0)
    return np.array([k, y0 - k * x0], np.float64)


def polyval2(p, x):
    """Evaluate quadratic [p0,p1,p2] — works on numpy arrays or tensors."""
    return (p[0] * x + p[1]) * x + p[2]


def polyval3(p, x):
    """Evaluate cubic [p0,p1,p2,p3]."""
    return ((p[0] * x + p[1]) * x + p[2]) * x + p[3]
