"""Convergence checkers (host-side, numpy).

A copy of the JAX package's ``spatial_alignment_tpu/utils/convergence.py``
(the port imports nothing of that package): a polynomial-smoothed
relative-change test and a windowed mean-decrease early stop, for
``VariationalGPSA.fit(convergence_checker=...)``. Both read the host loss
trace that ``fit`` copies back once per chunk.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ConvergenceChecker", "LossNotDecreasingChecker"]


class ConvergenceChecker:
    """Declare convergence when the smoothed loss stops moving.

    The last ``span`` loss values are projected onto a cubic-polynomial
    subspace (a least-squares smooth), and the relative change between the
    last two smoothed values is compared against ``tol``.
    """

    def __init__(self, span: int, dtp: str = "float64"):
        if span < 4:
            raise ValueError("span must be >= 4 to fit a cubic")
        self.span = int(span)
        t = np.arange(self.span, dtype=dtp)
        t = t - t.mean()
        # Orthonormal basis Q for span(1, t, t^2, t^3); projection = Q Q^T y.
        basis = np.stack([t**p for p in range(4)], axis=1)
        self._Q, _ = np.linalg.qr(basis)

    def smooth(self, y):
        """Least-squares cubic fit evaluated at the window points."""
        return self._Q @ (self._Q.T @ np.asarray(y))

    def subset(self, y, idx: int = -1):
        """The length-``span`` window of ``y`` ending at position ``idx``."""
        y = np.asarray(y)
        end = len(y) if idx == -1 else idx + 1
        return y[end - self.span : end]

    def relative_change(self, y, idx: int = -1, smooth: bool = True):
        """Relative step between the final two (optionally smoothed) values."""
        window = self.subset(y, idx=idx)
        if smooth:
            window = self.smooth(window)
        last, prev = window[-1], window[-2]
        return (last - prev) / (0.1 + abs(prev))

    def converged(self, y, tol: float = 1e-4, **kwargs) -> bool:
        return bool(abs(self.relative_change(y, **kwargs)) < tol)

    def relative_change_all(self, y, smooth: bool = True):
        """Relative change at every index with a full trailing window.

        Entries before index ``span`` are NaN (not enough history).
        """
        y = np.asarray(y)
        out = np.full(len(y), np.nan)
        for i in range(self.span, len(y)):
            out[i] = self.relative_change(y, idx=i, smooth=smooth)
        return out

    def converged_all(self, y, tol: float = 1e-4, smooth: bool = True):
        return np.abs(self.relative_change_all(y, smooth=smooth)) < tol


class LossNotDecreasingChecker:
    """Early stop when the average per-step loss decrease falls below atol.

    The averaged quantity is the mean of ``loss[j-1] - loss[j]`` for the
    ``window_size - 1`` steps preceding the current one, which telescopes to
    ``(loss[i-w] - loss[i-1]) / (w - 1)``. Callable, so it plugs straight
    into ``VariationalGPSA.fit(convergence_checker=...)``.
    """

    def __init__(self, max_epochs: int, atol: float = 1e-2, window_size: int = 10):
        self.max_epochs = int(max_epochs)
        self.atol = float(atol)
        self.window_size = int(window_size)
        # Kept for introspection parity with the reference API.
        self.decrease_in_loss = np.zeros(self.max_epochs)
        self.average_decrease_in_loss = np.zeros(self.max_epochs)

    def check_loss(self, iternum: int, loss_trace) -> bool:
        if iternum < 1:
            return False
        self.decrease_in_loss[iternum] = loss_trace[iternum - 1] - loss_trace[iternum]
        w = self.window_size
        if iternum < w or w < 2:
            return False
        avg = (loss_trace[iternum - w] - loss_trace[iternum - 1]) / (w - 1)
        self.average_decrease_in_loss[iternum] = avg
        return bool(avg < self.atol)

    __call__ = check_loss
