"""Complex block LOBPCG for the top eigenpairs of a Hermitian operator.

The JAX package calls ``jax.experimental.sparse.linalg.lobpcg_standard``
on a real ``[[Re H, -Im H], [Im H, Re H]]`` embedding of a complex H,
because the TPU had no complex eigensolver.  This is the same algorithm
written for complex blocks, so the embedding (which doubled both the
dimension and the block) is gone: the orthonormal X, P, R blocks, the
SVQB orthonormalization, the "twice is enough" projection, the
Householder extension of the first P, the Rayleigh-Ritz step on
[X, P, R], the QR of the difference terms, and the exit test
``|A x - theta x| < tol * 10 * n * (|A x| + theta)`` per column, with
``max_iters`` and ``tol`` as JAX defines them (``n`` is the complex
dimension here).  Conjugate transposes take the place of transposes.

``torch.lobpcg`` is not used: it takes real symmetric problems, and on a
complex Hermitian matrix it returned eigenvalues near -1e20 (torch
2.13, CPU).  Everything here is plain torch; the operator ``A`` is the
caller's (kernel 8 on the card).
"""

from __future__ import annotations

import torch

__all__ = ["lobpcg_standard"]


def _herm(S):
    return 0.5 * (S + S.conj().transpose(-1, -2))


def _eigh_descending(S):
    w, V = torch.linalg.eigh(_herm(S))
    return w.flip(-1), V.flip(-1)


def _colnorm(X):
    return torch.linalg.vector_norm(X, dim=0, keepdim=True)


def _svqb(X):
    """Orthonormal basis of the columns of X, rank-deficient directions
    zeroed (SVQB, https://sdm.lbl.gov/~kewu/ps/45577.html)."""
    norms = _colnorm(X)
    X = X / torch.where(norms == 0, torch.ones_like(norms), norms)
    inner = X.conj().T @ X
    w, V = _eigh_descending(inner)
    tau = torch.finfo(w.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, torch.ones_like(padded)) ** -0.5
    orth = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner).real > 0.0))[None, :]
    orth = orth * keep
    norms = _colnorm(orth)
    keep = keep & (norms > 0.0)
    return orth / torch.where(keep, norms, torch.ones_like(norms))


def _orthonormalize(X):
    for _ in range(2):
        X = _svqb(X)
    return X


def _project_out(basis, U):
    """The component of U orthogonal to the orthonormal ``basis``, its
    nonzero columns orthonormal; columns that lose their norm are zeroed."""
    for _ in range(2):
        U = U - basis @ (basis.conj().T @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.conj().T @ U)
    return U * (_colnorm(U) >= 0.99)


def _rayleigh_ritz_orth(A, S):
    return _eigh_descending(S.conj().T @ A(S))


def _extend_basis(X, m):
    """m orthonormal columns orthogonal to the orthonormal X (n, k), by a
    block Householder reflector built from X (deterministic)."""
    n, k = X.shape
    upper, lower = X[:k], X[k:]
    u, s, vh = torch.linalg.svd(upper)
    y = torch.cat([upper + u @ vh, lower], dim=0)
    other = torch.cat([torch.eye(m, dtype=X.dtype, device=X.device),
                       torch.zeros((n - k - m, m), dtype=X.dtype, device=X.device)], dim=0)
    w = y @ (vh.conj().T * ((2.0 * (1.0 + s)) ** -0.5)[None, :])
    h = -2.0 * (w @ (w[k:].conj().T @ other))
    h[k:] += other
    return h


def lobpcg_standard(A, X, m=100, tol=None):
    """Top-k eigenpairs of the Hermitian operator ``A`` by block LOBPCG.

    :param A: callable, (n, B) complex -> A @ block
    :param X: (n, k) complex start block, numerically independent;
      ``0 < 5 k < n``
    :param m: iteration cap
    :param tol: a column is converged when ``|A x - theta x| < tol * 10 *
      n * (|A x| + theta)``; the loop ends when all k are (None: float64
      epsilon)
    :returns: ``(theta, X, iterations)``: (k,) eigenvalues, descending;
      (n, k) eigenvectors
    """
    n, k = X.shape
    if k == 0:
        raise ValueError("must have search dim > 0, got %d" % k)
    if k * 5 >= n:
        raise ValueError("expected search dim * 5 < matrix dim (got %d, %d)" % (k * 5, n))
    if tol is None:
        tol = float(torch.finfo(X.real.dtype).eps)

    X = _orthonormalize(X)
    P = _extend_basis(X, k)
    AX = A(X)
    theta = torch.sum(X.conj() * AX, dim=0).real
    R = AX - theta[None, :] * X
    it = 0
    converged = 0
    while it < int(m) and converged < k:
        R = _project_out(torch.cat([X, P], dim=1), R)
        XPR = torch.cat([X, P, R], dim=1)
        theta, Q = _rayleigh_ritz_orth(A, XPR)
        B = Q[:, :k]
        B = B / _colnorm(B)
        X = XPR @ B
        X = X / _colnorm(X)
        # difference terms: the part of [0; Q[k:, :k]] orthogonal to
        # Q[:, :k], mapped through the orthonormal XPR
        q, _ = torch.linalg.qr(Q[:k, k:].conj().T)
        P = XPR @ (Q[:, k:] @ q)
        normP = _colnorm(P)
        P = P / torch.where(normP == 0, torch.ones_like(normP), normP)
        AX = A(X)
        R = AX - theta[None, :k] * X
        resid = torch.linalg.vector_norm(R, dim=0)
        reltol = 10.0 * n * (torch.linalg.vector_norm(AX, dim=0) + theta[:k])
        converged = int((resid < tol * reltol).sum())
        it += 1
    return theta[:k], X, it
