"""Closed-form variance expressions from the paper's §3 / Appendix 6.2
(PyTorch port of ``repro.core.theory``; numpy throughout).

They check the sketch's inner-product estimator against Theorem 1:

    E[ <x,y>^ ] = <x,y>                                   (Eq. 5, signs on)
    V_1(x,y,n,m) = (1/m) ( Σ_{C_i≠C_j} x_i² y_j²  +  Σ_{C_i≠C_j} x_i y_i x_j y_j )
    V_Z(x,y,n,m) = V_1(x,y,n,m) − Σ_c V_1(x_c, y_c, Z, m)  (Eq. 22)

so ROBE-Z variance ≤ ROBE-1 (feature hashing) variance, with equality iff
every block holds a single element.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.robe import RobeSpec, sketch_vector


def feature_hashing_variance(x: np.ndarray, y: np.ndarray, m: int) -> float:
    """V_1 for plain feature hashing (Weinberger et al.; Z=1)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    sx2 = float(np.sum(x * x))
    sy2 = float(np.sum(y * y))
    sxy = float(np.sum(x * y))
    # Σ_{i≠j} x_i² y_j² = Σx² Σy² − Σ x_i² y_i²
    t1 = sx2 * sy2 - float(np.sum(x * x * y * y))
    # Σ_{i≠j} x_i y_i x_j y_j = (Σ x_i y_i)² − Σ (x_i y_i)²
    t2 = sxy * sxy - float(np.sum((x * y) ** 2))
    return (t1 + t2) / m


def robe_variance(x: np.ndarray, y: np.ndarray, z: int, m: int) -> float:
    """V_Z from Eq. 22: feature-hashing variance minus the within-block part."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[0]
    v = feature_hashing_variance(x, y, m)
    for start in range(0, n, z):
        v -= feature_hashing_variance(x[start:start + z], y[start:start + z],
                                      m)
    return v


def inner_product_estimates(x: np.ndarray, y: np.ndarray, z: int, m: int,
                            n_seeds: int, use_sign: bool = True
                            ) -> np.ndarray:
    """Monte-Carlo <x,y>^ over independent hash draws (seeds 0..n-1)."""
    outs = np.empty(n_seeds, dtype=np.float64)
    for s in range(n_seeds):
        spec = RobeSpec(size=m, block_size=z, seed=s, use_sign=use_sign)
        xs = sketch_vector(np.asarray(x, np.float64), spec)
        ys = sketch_vector(np.asarray(y, np.float64), spec)
        outs[s] = float(np.dot(xs, ys))
    return outs
