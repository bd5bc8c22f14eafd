"""Mergeable t-digest sketch (counterpart of
``arrow_tpu/utils/tdigest.py``; reference: cpp/src/arrow/util/tdigest.h).
Host work in numpy: the engine's quantiles are exact (one sort), and the
sketch serves states that are merged without their rows (per rank or per
shard) or that must stay small under a stream.

The digest is built with array operations (sort, cumulative weight,
bucketing on the k1 scale ``k(q) = delta/(2*pi) * asin(2q-1)``, a
segment sum) instead of Arrow's sequential walk over the centroids; each
centroid still spans at most one unit of the scale.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence, Union

import numpy as np


class TDigest:
    """Immutable-ish t-digest: centroid means + weights sorted by mean."""

    __slots__ = ("delta", "means", "weights", "min", "max")

    def __init__(self, delta: int = 100,
                 means: np.ndarray = None, weights: np.ndarray = None,
                 vmin: float = math.inf, vmax: float = -math.inf):
        self.delta = int(delta)
        self.means = np.asarray([] if means is None else means, np.float64)
        self.weights = np.asarray(
            [] if weights is None else weights, np.float64)
        self.min = float(vmin)
        self.max = float(vmax)

    # -- scale function (k1, matches util/tdigest.cc ScalerK1) -----------
    def _k(self, q: np.ndarray) -> np.ndarray:
        return self.delta / (2.0 * np.pi) * np.arcsin(2.0 * q - 1.0)

    @property
    def total_weight(self) -> float:
        return float(self.weights.sum())

    def __len__(self) -> int:
        return len(self.means)

    # -- build ------------------------------------------------------------
    @classmethod
    def from_array(cls, values, delta: int = 100) -> "TDigest":
        v = np.asarray(values, np.float64)
        v = v[~np.isnan(v)]
        if v.size == 0:
            return cls(delta)
        v = np.sort(v)
        d = cls(delta, vmin=float(v[0]), vmax=float(v[-1]))
        d.means, d.weights = d._compress(v, np.ones(v.size, np.float64))
        return d

    def _compress(self, means: np.ndarray, weights: np.ndarray):
        """Cluster (mean-sorted) weighted points into k-scale buckets."""
        n = weights.sum()
        if n <= 0:
            return np.empty(0), np.empty(0)
        # quantile of each point's weight midpoint
        cw = np.cumsum(weights)
        q = (cw - weights / 2.0) / n
        bucket = np.floor(self._k(q) - self._k(np.asarray(1e-12))) \
            .astype(np.int64)
        # segment-reduce by bucket id
        new_seg = np.empty(len(bucket), bool)
        new_seg[0] = True
        np.not_equal(bucket[1:], bucket[:-1], out=new_seg[1:])
        starts = np.nonzero(new_seg)[0]
        wsum = np.add.reduceat(weights, starts)
        msum = np.add.reduceat(weights * means, starts)
        return msum / wsum, wsum

    # -- merge ------------------------------------------------------------
    def merge(self, others: Union["TDigest", Iterable["TDigest"]]
              ) -> "TDigest":
        """Merge digests into a new digest (tdigest.h Merge semantics)."""
        if isinstance(others, TDigest):
            others = [others]
        ds = [self, *others]
        means = np.concatenate([d.means for d in ds])
        weights = np.concatenate([d.weights for d in ds])
        out = TDigest(self.delta,
                      vmin=min(d.min for d in ds),
                      vmax=max(d.max for d in ds))
        if means.size:
            order = np.argsort(means, kind="stable")
            out.means, out.weights = self._compress(
                means[order], weights[order])
        return out

    # -- query ------------------------------------------------------------
    def quantile(self, q: Union[float, Sequence[float]]):
        """Quantile estimate(s); scalar in -> scalar out."""
        scalar = np.isscalar(q)
        qs = np.atleast_1d(np.asarray(q, np.float64))
        if len(self) == 0:
            out = np.full(qs.shape, np.nan)
            return float(out[0]) if scalar else out
        w = self.weights
        n = w.sum()
        # centroid midpoints in cumulative-weight space
        cw = np.cumsum(w)
        mid = cw - w / 2.0
        targets = np.clip(qs, 0.0, 1.0) * n
        idx = np.searchsorted(mid, targets)
        lo = np.clip(idx - 1, 0, len(w) - 1)
        hi = np.clip(idx, 0, len(w) - 1)
        mlo, mhi = self.means[lo], self.means[hi]
        span = mid[hi] - mid[lo]
        frac = np.where(span > 0, (targets - mid[lo]) / np.where(
            span > 0, span, 1.0), 0.0)
        est = mlo + (mhi - mlo) * frac
        # exact tails
        est = np.where(targets <= mid[0], np.interp(
            targets, [0.0, mid[0]], [self.min, self.means[0]]), est)
        est = np.where(targets >= mid[-1], np.interp(
            targets, [mid[-1], n], [self.means[-1], self.max]), est)
        est = np.clip(est, self.min, self.max)
        return float(est[0]) if scalar else est

    def median(self) -> float:
        return self.quantile(0.5)

    def mean(self) -> float:
        n = self.total_weight
        return float((self.means * self.weights).sum() / n) if n else \
            math.nan

    def __repr__(self):
        return (f"<TDigest delta={self.delta} centroids={len(self)} "
                f"n={self.total_weight:.0f}>")
