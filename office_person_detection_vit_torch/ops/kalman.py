"""Constant-velocity Kalman filter with an adaptive dt.

Mirrors ``office_person_detection_vit_tpu/ops/kalman.py``: state [px, py, vx,
vy], the transition F and the white-noise-acceleration process noise Q
recomputed for each dt, the standard predict and update. Two forms:

- numpy (``kf_init_np``, ``kf_predict_np``, ``kf_update_np``): one filter a
  track, for the host loops of the cascade and the hybrid tracker;
- torch, batched over track slots on any device (``kf_predict_batch``,
  ``kf_update_batch``), for the scan tracker. They are written out element
  by element (no matmul, and the 2x2 inverse in closed form), so that every
  result is a chain of correctly rounded operations: the card and the CPU
  give the same bits, and nothing in them synchronises with the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class KFState(NamedTuple):
    x: np.ndarray  # (4,) [px, py, vx, vy]
    P: np.ndarray  # (4, 4) covariance


DEFAULT_PROCESS_NOISE = 1.0
DEFAULT_MEASUREMENT_NOISE = 10.0
DEFAULT_INIT_VELOCITY_VAR = 1000.0


def kf_position(state: KFState):
    return state.x[..., :2]


# ----------------------------------------------------------------- numpy
def kf_init_np(pos, init_velocity_var: float = DEFAULT_INIT_VELOCITY_VAR) -> KFState:
    pos = np.asarray(pos, np.float32)
    x = np.concatenate([pos, np.zeros(2, np.float32)])
    P = np.diag(np.asarray([10.0, 10.0, init_velocity_var, init_velocity_var], np.float32))
    return KFState(x=x, P=P)


def _transition_np(dt: float) -> tuple[np.ndarray, np.ndarray]:
    dt = float(dt)
    F = np.eye(4, dtype=np.float32)
    F[0, 2] = dt
    F[1, 3] = dt
    dt2 = dt * dt
    dt3 = dt2 * dt / 2.0
    dt4 = dt2 * dt2 / 4.0
    q = DEFAULT_PROCESS_NOISE
    Q = np.zeros((4, 4), np.float32)
    Q[0, 0] = Q[1, 1] = dt4 * q
    Q[0, 2] = Q[2, 0] = Q[1, 3] = Q[3, 1] = dt3 * q
    Q[2, 2] = Q[3, 3] = dt2 * q
    return F, Q


def kf_predict_np(state: KFState, dt: float = 1.0) -> KFState:
    F, Q = _transition_np(dt)
    return KFState(x=F @ state.x, P=F @ state.P @ F.T + Q)


def kf_update_np(state: KFState, z, meas_noise: float = DEFAULT_MEASUREMENT_NOISE) -> KFState:
    z = np.asarray(z, np.float32)
    H = np.zeros((2, 4), np.float32)
    H[0, 0] = H[1, 1] = 1.0
    R = np.eye(2, dtype=np.float32) * meas_noise
    y = z - H @ state.x
    S = H @ state.P @ H.T + R
    K = state.P @ H.T @ np.linalg.inv(S)
    x = state.x + K @ y
    P = (np.eye(4, dtype=np.float32) - K @ H) @ state.P
    return KFState(x=x, P=P)


# ------------------------------------------------------- torch, batched
def kf_predict_batch(x: torch.Tensor, P: torch.Tensor, dt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T, 4), P (T, 4, 4), dt () or (T,) -> F x, F P F^T + Q.

    F adds dt times the velocity to the position; Q is the
    white-noise-acceleration noise of ``_transition_np`` (q dt^4/4 on the
    positions, q dt^3/2 between a position and its velocity, q dt^2 on the
    velocities).
    """
    dt = dt.to(x.dtype).expand(x.shape[0])[:, None]
    q = DEFAULT_PROCESS_NOISE
    dt2 = dt * dt
    dt3 = dt2 * dt / 2.0 * q
    dt4 = dt2 * dt2 / 4.0 * q
    dt2 = dt2 * q
    # F P: the position rows gain dt times the velocity rows.
    A = torch.cat([P[:, :2] + dt[..., None] * P[:, 2:], P[:, 2:]], dim=1)
    # (F P) F^T: the same on the columns.
    B = torch.cat([A[:, :, :2] + dt[:, None] * A[:, :, 2:], A[:, :, 2:]], dim=2)
    zero = torch.zeros_like(dt)
    Q = torch.stack([
        torch.cat([dt4, zero, dt3, zero], 1), torch.cat([zero, dt4, zero, dt3], 1),
        torch.cat([dt3, zero, dt2, zero], 1), torch.cat([zero, dt3, zero, dt2], 1),
    ], dim=1)
    x_new = torch.cat([x[:, :2] + dt * x[:, 2:], x[:, 2:]], dim=1)
    return x_new, B + Q


def kf_update_batch(x: torch.Tensor, P: torch.Tensor, z: torch.Tensor,
                    meas_noise: float = DEFAULT_MEASUREMENT_NOISE) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T, 4), P (T, 4, 4), z (T, 2) measured positions -> updated x, P.

    H picks the position, so S = P[:2, :2] + R, K = P[:, :2] S^-1 (the 2x2
    inverse in closed form), x + K (z - x[:2]) and P - K P[:2, :].
    """
    a, b = P[:, 0, 0] + meas_noise, P[:, 0, 1]
    c, d = P[:, 1, 0], P[:, 1, 1] + meas_noise
    det = a * d - b * c
    s_inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], dim=1) / det[:, None, None]
    PH = P[:, :, :2]  # (T, 4, 2) = P H^T
    K = PH[:, :, :1] * s_inv[:, None, 0, :] + PH[:, :, 1:] * s_inv[:, None, 1, :]  # (T, 4, 2)
    y = z - x[:, :2]
    x_new = x + K[:, :, 0] * y[:, :1] + K[:, :, 1] * y[:, 1:]
    P_new = P - (K[:, :, :1] * P[:, None, 0, :] + K[:, :, 1:] * P[:, None, 1, :])
    return x_new, P_new
