"""numpy stand-ins for the two scikit-learn estimators the JAX eval code
uses (``multivae_tpu/eval/prd.py:44-59``, ``representation.py:63``,
``coherence.py:33-34``); the card's machine has no scikit-learn.

* :class:`KMeans` is ``sklearn.cluster.KMeans(n_clusters, n_init,
  random_state).fit_predict`` with the Lloyd algorithm: the data centred by
  its mean, k-means++ seeding drawn from one ``np.random.RandomState(
  random_state)`` reused by every init in scikit-learn's order (the first
  centre from ``choice`` with ``p``, then ``2 + int(log k)`` local trials
  from ``uniform(size) * potential`` and ``searchsorted`` on the cumulative
  distances), Lloyd steps with empty clusters moved to the farthest points,
  the stop at unchanged labels or at a squared centre shift within ``tol``
  times the mean per-feature variance, and the best init by inertia (a tie
  or the same clustering keeps the earlier one). Float64 throughout. Sums
  run in numpy's order, not the Cython loops', so a label can differ only
  where two centres are at the same distance to rounding.
* :class:`LogisticRegression` is ``sklearn.linear_model.LogisticRegression(
  C=1, max_iter)`` with the lbfgs solver: the L2-penalised (intercept not
  penalised) binomial loss for two classes, multinomial for more, minimised
  by ``scipy.optimize.minimize(method="L-BFGS-B")`` from zero, to a
  gradient tolerance (``gtol``) far below scikit-learn's ``tol=1e-4``, so
  its coefficients sit within scikit-learn's own error of the optimum.
"""

from __future__ import annotations

import numpy as np
from scipy import optimize
from scipy.special import expit, logsumexp


class KMeans:
    """k-means++ seeded Lloyd clustering; see the module docstring.
    ``MAX_ITER`` and ``TOL`` are scikit-learn's defaults."""

    MAX_ITER, TOL = 300, 1e-4

    def __init__(self, n_clusters: int = 8, n_init: int = 10,
                 random_state=None):
        self.n_clusters = int(n_clusters)
        self.n_init = int(n_init)
        self.random_state = random_state

    def fit(self, X):
        X = np.array(X, dtype=np.float64, order="C")  # a copy: centred below
        n, k = X.shape[0], self.n_clusters
        if n < k:
            raise ValueError(f"n_samples={n} should be >= n_clusters={k}")
        rs = (self.random_state
              if isinstance(self.random_state, np.random.RandomState)
              else np.random.RandomState(self.random_state))
        tol = float(np.mean(np.var(X, axis=0)) * self.TOL)
        mean = X.mean(axis=0)
        X -= mean
        x_sq = np.einsum("ij,ij->i", X, X)
        best = None
        for _ in range(self.n_init):
            centers = _kmeans_plusplus(X, k, x_sq, rs)
            labels, inertia, centers = _lloyd(X, centers, self.MAX_ITER, tol)
            if best is None or (inertia < best[1] and not _same_clustering(
                    labels, best[0], k)):
                best = (labels, inertia, centers)
        self.labels_, self.inertia_, centers = best
        self.cluster_centers_ = centers + mean
        return self

    def fit_predict(self, X):
        return self.fit(X).labels_


def _sq_distances(Y, X, x_sq):
    """``||y - x||^2`` for every row pair, as scikit-learn's
    ``euclidean_distances(squared=True)`` forms it: ``-2 Y X^T + |y|^2 +
    |x|^2``, clipped at 0."""
    d = -2.0 * (Y @ X.T)
    d += np.einsum("ij,ij->i", Y, Y)[:, None]
    d += x_sq[None, :]
    np.maximum(d, 0.0, out=d)
    return d


def _kmeans_plusplus(X, k, x_sq, rs):
    n = X.shape[0]
    weight = np.ones(n)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, X.shape[1]))
    first = rs.choice(n, p=weight / weight.sum())
    centers[0] = X[first]
    closest = _sq_distances(X[[first]], X, x_sq)          # [1, n]
    pot = closest @ weight
    for c in range(1, k):
        rand = rs.uniform(size=trials) * pot
        cand = np.searchsorted(np.cumsum(weight * closest), rand)
        np.clip(cand, None, closest.size - 1, out=cand)
        dist = _sq_distances(X[cand], X, x_sq)
        np.minimum(closest, dist, out=dist)
        cand_pot = dist @ weight.reshape(-1, 1)
        j = int(np.argmin(cand_pot))
        pot = cand_pot[j]
        closest = dist[j]
        centers[c] = X[cand[j]]
    return centers


def _assign(X, centers):
    """Nearest centre per row by ``|c|^2 - 2 x.c`` (``|x|^2`` left out, as
    scikit-learn's Lloyd step), the first on a tie."""
    d = np.einsum("ij,ij->i", centers, centers)[None, :] - 2.0 * (
        X @ centers.T)
    return np.argmin(d, axis=1).astype(np.int32)


def _lloyd_step(X, centers, labels):
    """New centres from ``labels`` (each empty cluster takes the point
    farthest from its centre, farthest first) and the shift of each."""
    k = centers.shape[0]
    counts = np.bincount(labels, minlength=k).astype(np.float64)
    # each cluster's rows summed in sample order (a stable sort, then one
    # segment sum per non-empty cluster)
    sums = np.zeros_like(centers)
    nonempty = counts > 0
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    sums[nonempty] = np.add.reduceat(
        X[np.argsort(labels, kind="stable")], starts[nonempty], axis=0)
    empty = np.flatnonzero(counts == 0)
    if len(empty):
        far_d = ((X - centers[labels]) ** 2).sum(axis=1)
        far = np.argpartition(far_d, -len(empty))[:-len(empty) - 1:-1]
        for new_id, idx in zip(empty, far):
            old_id = labels[idx]
            sums[old_id] -= X[idx]
            sums[new_id] = X[idx]
            counts[new_id] = 1.0
            counts[old_id] -= 1.0
    nonzero = counts > 0
    sums[nonzero] *= (1.0 / counts[nonzero])[:, None]
    shift = np.sqrt(((sums - centers) ** 2).sum(axis=1))
    return sums, shift


def _lloyd(X, centers, max_iter, tol):
    labels_old = np.full(X.shape[0], -1, dtype=np.int32)
    strict = False
    for _ in range(max_iter):
        labels = _assign(X, centers)
        centers, shift = _lloyd_step(X, centers, labels)
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(X, centers)
    inertia = float(((X - centers[labels]) ** 2).sum())
    return labels, inertia, centers


def _same_clustering(labels1, labels2, k) -> bool:
    """Whether two labelings are one clustering up to a renaming."""
    mapping = np.full(k, -1, dtype=np.int64)
    for a, b in zip(labels1, labels2):
        if mapping[a] == -1:
            mapping[a] = b
        elif mapping[a] != b:
            return False
    return True


class LogisticRegression:
    """L2-penalised logistic regression by L-BFGS-B; see the module
    docstring. ``coef_`` is ``[1, F]`` for two classes, ``[K, F]`` for
    more; ``intercept_`` likewise ``[1]`` or ``[K]``. ``C`` is
    scikit-learn's default, ``GTOL`` the gradient tolerance."""

    C, GTOL = 1.0, 1e-10

    def __init__(self, max_iter: int = 1000):
        self.max_iter = int(max_iter)

    def fit(self, X, y):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        k = len(self.classes_)
        if k < 2:
            raise ValueError("needs samples of at least 2 classes, got "
                             f"{k}")
        n, f = X.shape
        # scikit-learn's scaling of the objective: the mean loss plus
        # ||w||^2 / (2 C n); the same argmin as C sum(loss) + ||w||^2 / 2
        l2 = 1.0 / (self.C * n)
        Xb = np.hstack([X, np.ones((n, 1))])
        if k == 2:
            t = (y == self.classes_[1]).astype(np.float64)
            fun, w0 = _binomial(Xb, t, l2), np.zeros(f + 1)
        else:
            t = np.searchsorted(self.classes_, y)
            fun, w0 = _multinomial(Xb, t, k, l2), np.zeros(k * (f + 1))
        res = optimize.minimize(
            fun, w0, jac=True, method="L-BFGS-B",
            options={"maxiter": self.max_iter, "maxls": 50,
                     "gtol": self.GTOL, "ftol": 64 * np.finfo(float).eps})
        w = res.x.reshape(1 if k == 2 else k, f + 1)
        self.coef_ = w[:, :f].copy()
        self.intercept_ = w[:, f].copy()
        self.n_iter_ = np.asarray([res.nit])
        return self

    def decision_function(self, X):
        """``X @ coef_.T + intercept_``: ``[n]`` for two classes (the
        second class's logit), ``[n, K]`` for more."""
        scores = np.asarray(X, dtype=np.float64) @ self.coef_.T \
            + self.intercept_
        return scores[:, 0] if scores.shape[1] == 1 else scores

    def predict(self, X):
        scores = self.decision_function(X)
        idx = ((scores > 0).astype(int) if scores.ndim == 1
               else scores.argmax(axis=1))
        return self.classes_[idx]

    def score(self, X, y) -> float:
        """Accuracy on ``(X, y)``."""
        return float(np.mean(self.predict(X) == np.asarray(y)))


# The objectives' products are einsums, numpy's own loops, not BLAS: the
# L-BFGS-B routine calls scipy's BLAS between them, and two BLAS thread
# pools that wait by spinning, taking turns, made a fit many times slower.
def _binomial(Xb, t, l2):
    n = Xb.shape[0]

    def fun(w):
        z = np.einsum("ij,j->i", Xb, w)
        loss = (np.logaddexp(0.0, z) - t * z).sum() / n
        grad = np.einsum("ij,i->j", Xb, expit(z) - t) / n
        wf = w[:-1]
        return loss + 0.5 * l2 * wf @ wf, grad + l2 * np.append(wf, 0.0)

    return fun


def _multinomial(Xb, t, k, l2):
    n, f1 = Xb.shape
    onehot = np.eye(k)[t]

    def fun(w):
        W = w.reshape(k, f1)
        z = np.einsum("ij,kj->ik", Xb, W)                  # [n, k]
        lse = logsumexp(z, axis=1)
        loss = (lse - z[np.arange(n), t]).sum() / n
        grad = np.einsum("ik,ij->kj", np.exp(z - lse[:, None]) - onehot,
                         Xb) / n
        Wf = W.copy()
        Wf[:, -1] = 0.0
        return (loss + 0.5 * l2 * (Wf * Wf).sum(),
                (grad + l2 * Wf).ravel())

    return fun
