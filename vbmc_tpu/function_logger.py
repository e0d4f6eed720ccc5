"""Evaluation gateway and cache (cf. `misc/funlogger_vbmc.m`).

Host-side component: the target function is an arbitrary (possibly noisy)
black box, so its bookkeeping lives outside jit. Stores both original- and
transformed-space coordinates, applies the log-Jacobian correction and
tempering, validates outputs, and merges duplicate evaluations with
precision weighting (`funlogger_vbmc.m:229-247`).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from vbmc_tpu.transforms import (Trinfo, inverse_np, direct_np,
                                 log_abs_det_jacobian_np)


class FunctionLogger:
    def __init__(self, fun: Callable, D: int, trinfo: Trinfo,
                 uncertainty_level: int = 0, cache_size: int = 500,
                 temperature: float = 1.0):
        self.fun = fun
        self.D = D
        self.trinfo = trinfo
        self.noise_flag = uncertainty_level > 0
        self.uncertainty_level = uncertainty_level
        self.T = temperature
        n = cache_size
        self.X_orig = np.full((n, D), np.nan)
        self.y_orig = np.full(n, np.nan)
        self.X = np.full((n, D), np.nan)
        self.y = np.full(n, np.nan)
        self.S = np.full(n, np.nan) if self.noise_flag else None
        self.nevals = np.zeros(n, dtype=int)
        self.X_flag = np.zeros(n, dtype=bool)
        self.fun_eval_time = np.full(n, np.nan)
        self.Xn = 0
        self.func_count = 0
        self.cache_count = 0
        self.total_fun_eval_time = 0.0
        self.ymax = -np.inf

    # ------------------------------------------------------------------
    def _grow(self, need: int):
        cap = self.X_orig.shape[0]
        if need <= cap:
            return
        new = max(int(np.ceil(cap * 1.5)), need)

        def ex(a, fill=np.nan):
            out = np.full((new,) + a.shape[1:], fill, dtype=a.dtype)
            out[:cap] = a
            return out
        self.X_orig = ex(self.X_orig)
        self.y_orig = ex(self.y_orig)
        self.X = ex(self.X)
        self.y = ex(self.y)
        if self.S is not None:
            self.S = ex(self.S)
        self.nevals = ex(self.nevals, 0)
        self.X_flag = ex(self.X_flag, False)
        self.fun_eval_time = ex(self.fun_eval_time)

    def _logjac(self, x: np.ndarray) -> float:
        # Host math: one evaluation's bookkeeping must not pay device
        # round-trips.
        return float(log_abs_det_jacobian_np(self.trinfo, x[None, :])[0])

    # ------------------------------------------------------------------
    def evaluate(self, x: np.ndarray):
        """Evaluate the target at transformed-space point x and record it.

        Returns (y_transformed, idx).
        """
        x = np.asarray(x, float).ravel()
        x_orig = inverse_np(self.trinfo, x[None, :])[0]
        t0 = time.monotonic()
        if self.uncertainty_level == 2:
            out = self.fun(x_orig)
            # `funlogger_vbmc.m` (uncertainty-handling branch): the target
            # must return the pair (fval, noise_sd).
            try:
                fval_orig, fsd = float(out[0]), float(out[1])
            except (TypeError, IndexError):
                raise ValueError(
                    f"With specify_target_noise=True the target must return "
                    f"(fval, noise_sd); got {out!r} at {x_orig}.") from None
        else:
            out = self.fun(x_orig)
            arr = np.asarray(out)
            if arr.size != 1:
                # `funlogger_vbmc.m:87-89`: non-scalar returns are an error,
                # not silently truncated (a (fval, sd) pair here means the
                # user forgot specify_target_noise=True).
                raise ValueError(
                    f"Target function returned a non-scalar of shape "
                    f"{arr.shape} at {x_orig}; it must return a finite real "
                    f"scalar. (Noisy targets returning (fval, sd) need "
                    f"specify_target_noise=True.)")
            if not np.isrealobj(arr):
                # `funlogger_vbmc.m:119-123` rejects non-real returns
                # (~isreal) with a clear error, not a bare TypeError.
                raise ValueError(
                    f"Target function returned a non-real value {out!r} at "
                    f"{x_orig}; it must return a finite real scalar.")
            fval_orig = float(arr.ravel()[0])
            fsd = 1.0 if self.noise_flag else None
        dt = time.monotonic() - t0

        if not np.isfinite(fval_orig):
            raise ValueError(
                f"Target function returned non-finite value {fval_orig} at "
                f"{x_orig}; it must return a finite real scalar.")
        if self.noise_flag and (fsd is None or not np.isfinite(fsd)
                                or fsd <= 0):
            raise ValueError(
                f"Target noise SD must be a finite positive scalar, got {fsd}.")

        fval_orig /= self.T
        if fsd is not None:
            fsd /= self.T

        self.func_count += 1
        self.total_fun_eval_time += dt
        return self._record(x_orig, x, fval_orig, dt, fsd)

    def add(self, x: np.ndarray, y_orig: float, fsd: Optional[float] = None):
        """Record a pre-evaluated point (cache injection, warm starts)."""
        x = np.asarray(x, float).ravel()
        x_orig = inverse_np(self.trinfo, x[None, :])[0]
        if self.noise_flag and fsd is None:
            fsd = 1.0
        self.cache_count += 1
        return self._record(x_orig, x, float(y_orig) / self.T, 0.0,
                            None if fsd is None else fsd / self.T)

    # ------------------------------------------------------------------
    def _record(self, x_orig, x, fval_orig, dt, fsd):
        dup = np.where(self.X_flag[:self.Xn]
                       & np.all(self.X[:self.Xn] == x, axis=1))[0]
        if dup.size:
            idx = int(dup[0])
            N = self.nevals[idx]
            if fsd is not None:
                tau_n = 1.0 / self.S[idx] ** 2
                tau_1 = 1.0 / fsd ** 2
                self.y_orig[idx] = (tau_n * self.y_orig[idx]
                                    + tau_1 * fval_orig) / (tau_n + tau_1)
                self.S[idx] = 1.0 / np.sqrt(tau_n + tau_1)
            else:
                self.y_orig[idx] = (N * self.y_orig[idx] + fval_orig) / (N + 1)
            self.fun_eval_time[idx] = (N * self.fun_eval_time[idx] + dt) / (N + 1)
            self.nevals[idx] += 1
        else:
            self._grow(self.Xn + 1)
            idx = self.Xn
            self.Xn += 1
            self.X_orig[idx] = x_orig
            self.X[idx] = x
            self.y_orig[idx] = fval_orig
            if fsd is not None:
                self.S[idx] = fsd
            self.X_flag[idx] = True
            self.fun_eval_time[idx] = dt
            self.nevals[idx] = max(1, self.nevals[idx] + 1)

        fval = self.y_orig[idx] + self._logjac(x) / self.T
        self.y[idx] = fval
        active = self.X_flag[:self.Xn]
        self.ymax = np.max(self.y[:self.Xn][active]) if active.any() else -np.inf
        return fval, idx

    # ------------------------------------------------------------------
    def retransform(self, trinfo_new: Trinfo):
        """Rewrite transformed coordinates/values after an input warp
        (`warp_input_vbmc.m:111-119`)."""
        self.trinfo = trinfo_new
        n = self.Xn
        if n == 0:
            return
        Xo = self.X_orig[:n]
        U = direct_np(trinfo_new, Xo)
        lj = log_abs_det_jacobian_np(trinfo_new, U)
        self.X[:n] = U
        self.y[:n] = self.y_orig[:n] + lj / self.T
        active = self.X_flag[:n]
        self.ymax = np.max(self.y[:n][active]) if active.any() else -np.inf

    # ------------------------------------------------------------------
    @property
    def n_train(self) -> int:
        return int(np.sum(self.X_flag[:self.Xn]))

    @property
    def neff(self) -> float:
        return float(np.sum(self.nevals[:self.Xn][self.X_flag[:self.Xn]]))

    def training_data(self, noise_shaping=None, options=None):
        """(X, y, s2) of active training points (cf. `get_traindata_vbmc.m`)."""
        sel = self.X_flag[:self.Xn]
        X = self.X[:self.Xn][sel]
        y = self.y[:self.Xn][sel]
        if self.S is not None:
            s2 = self.S[:self.Xn][sel] ** 2
        else:
            s2 = None
        if noise_shaping is not None and options is not None:
            s2 = noise_shaping(s2, y, options)
        return X, y, s2
