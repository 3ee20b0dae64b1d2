"""Kalman filters for the offline tracker (host-side NumPy — the tracker is
inherently sequential; association IoU matrices run on device).

Independent re-derivation of the reference's two filters:
  * CenterKalmanFilter — the DetZero-tuned filter (kalman_filter.py:75):
    state [x, y, z, vx, vy], constant-velocity transition; the measurement
    update snaps the posterior center to the detection (the detector is
    trusted for position; the filter only smooths velocity); size/heading
    are carried from the detection, not filtered.
  * AB3DMOTFilter — classic 10-state baseline (ab3dmot.py:9) with
    heading-flip correction, implemented as a plain linear KF.

Reference-parity semantics (default, cfg PARITY: true — VERDICT r1 #4):
  * Q inflates 1.5x on EVERY predict, cumulatively, never reset
    (kalman_filter.py:99);
  * Vehicle velocity is zeroed when ||v|| <= max(size)/2, norm-based and
    size-relative (kalman_filter.py:92-95);
  * a stage-2 (loose) association match does NOT update the KF state,
    size, heading or box — only score/staleness bookkeeping
    (kalman_filter.py:120-122, update(two_stage=True) early-return);
  * update_score = max(score, 0.03) bookkeeping (kalman_filter.py:125).
PARITY: false restores the round-1 tuning (per-miss Q reset via
1.5**time_since_update, per-component fixed 0.3 m/s clamp for every
class, stage-2 matches fully update).

Port of detzero_tpu/models/tracking/kalman.py, unchanged but for the
imports (numpy and scipy).
"""

from __future__ import annotations

import numpy as np

from detzero_tpu_torch.core.registry import MOTION_FILTERS


@MOTION_FILTERS.register("CenterKalmanFilter")
class CenterKalmanFilter:
    """State: [x, y, z, vx, vy]. Box (7,) [x,y,z,dx,dy,dz,heading]."""

    X_DIM = 5

    def __init__(self, box, score, label, timestamp, cfg=None, delta_t=0.1):
        cfg = cfg or {}
        self.dt = delta_t
        q = cfg.get("Q", [5.0, 15.0])
        p = cfg.get("P", [50.0, 1000.0])
        r = float(cfg.get("R", 0.1))
        self.parity = bool(cfg.get("PARITY", True))
        self.min_velocity = float(cfg.get("MIN_VELOCITY", 0.3))
        # class identity for the vehicle-only parity clamp: string labels
        # compare directly; int labels map through CLASS_NAMES
        names = cfg.get("CLASS_NAMES", ["Vehicle", "Pedestrian", "Cyclist"])
        self.name = (label if isinstance(label, str)
                     else names[int(label)] if 0 <= int(label) < len(names)
                     else "Unknown")

        self.x = np.zeros(self.X_DIM)
        self.x[:3] = box[:3]
        self.P = np.eye(self.X_DIM)
        self.P[:3, :3] *= p[0]
        self.P[3:, 3:] *= p[1]
        self.Q = np.eye(self.X_DIM)
        self.Q[:3, :3] *= q[0]
        self.Q[3:, 3:] *= q[1]
        self.R = np.eye(3) * r
        self.F = np.eye(self.X_DIM)
        self.F[0, 3] = self.F[1, 4] = self.dt
        self.H = np.zeros((3, self.X_DIM))
        self.H[:3, :3] = np.eye(3)

        self.box = np.array(box, float)  # size/heading carried verbatim
        self.score = float(score)
        self.update_score = float(score)
        self.label = label
        self.time_since_update = 0

    def predict(self):
        if self.parity:
            # Vehicle velocity zeroed when its NORM is below half the
            # largest box extent (kalman_filter.py:92-95); Q grows 1.5x
            # per predict, cumulative, never reset (kalman_filter.py:99)
            if self.name == "Vehicle":
                v = self.x[3:5]
                if np.linalg.norm(v) <= np.max(self.box[3:6]) / 2.0:
                    v[:] = 0.0
            self.x = self.F @ self.x
            self.P = self.F @ self.P @ self.F.T + self.Q
            self.Q = self.Q * 1.5
        else:
            # round-1 tuning: per-component clamp, per-miss inflation
            v = self.x[3:5]
            v[np.abs(v) < self.min_velocity] = 0.0
            self.x = self.F @ self.x
            q = self.Q * (1.5 ** self.time_since_update)
            self.P = self.F @ self.P @ self.F.T + q
        self.time_since_update += 1
        out = self.box.copy()
        out[:3] = self.x[:3]
        return out

    def update(self, box, score, two_stage: bool = False):
        self.score = float(score)
        self.time_since_update = 0
        if two_stage and self.parity:
            # loose (stage-2) matches only refresh score/staleness; the KF
            # state, size, heading and box stay at the prediction
            # (kalman_filter.py:120-122)
            return
        z = np.asarray(box[:3], float)
        y = z - self.H @ self.x
        s = self.H @ self.P @ self.H.T + self.R
        k = self.P @ self.H.T @ np.linalg.inv(s)
        self.x = self.x + k @ y
        self.P = (np.eye(self.X_DIM) - k @ self.H) @ self.P
        # trust the detector's center exactly; KF state only shapes velocity
        self.x[:3] = z
        self.box = np.array(box, float)
        self.update_score = max(float(score), 0.03)

    @property
    def velocity(self):
        return self.x[3:5].copy()

    def current_box(self):
        out = self.box.copy()
        out[:3] = self.x[:3]
        return out


@MOTION_FILTERS.register("AB3DMOTFilter")
class AB3DMOTFilter:
    """10-state [x,y,z,yaw,l,w,h,vx,vy,vz] constant-velocity filter with the
    AB3DMOT heading-flip correction."""

    X_DIM = 10

    def __init__(self, box, score, label, timestamp, cfg=None, delta_t=0.1):
        cfg = cfg or {}
        self.dt = delta_t
        self.x = np.zeros(self.X_DIM)
        self.x[0:3] = box[:3]
        self.x[3] = box[6]
        self.x[4:7] = box[3:6]
        self.P = np.eye(self.X_DIM) * 10.0
        self.P[7:, 7:] *= 1000.0
        self.Q = np.eye(self.X_DIM) * 0.01
        self.Q[7:, 7:] *= 0.1
        self.R = np.eye(7) * 0.1
        self.F = np.eye(self.X_DIM)
        for i in range(3):
            self.F[i, 7 + i] = self.dt
        self.H = np.zeros((7, self.X_DIM))
        self.H[:7, :7] = np.eye(7)
        self.score = float(score)
        self.label = label
        self.time_since_update = 0

    def predict(self):
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q
        self.time_since_update += 1
        return self.current_box()

    def update(self, box, score, two_stage: bool = False):
        z = np.array([box[0], box[1], box[2], box[6], box[3], box[4], box[5]])
        # heading-flip correction: bring measurement within pi/2 of the state
        yaw_s, yaw_m = self.x[3], z[3]
        d = np.mod(yaw_m - yaw_s + np.pi, 2 * np.pi) - np.pi
        if abs(d) > np.pi / 2:
            yaw_m = yaw_m + np.pi if d < 0 else yaw_m - np.pi
            d = np.mod(yaw_m - yaw_s + np.pi, 2 * np.pi) - np.pi
        z[3] = yaw_s + d
        y = z - self.H @ self.x
        s = self.H @ self.P @ self.H.T + self.R
        k = self.P @ self.H.T @ np.linalg.inv(s)
        self.x = self.x + k @ y
        self.P = (np.eye(self.X_DIM) - k @ self.H) @ self.P
        self.score = float(score)
        self.time_since_update = 0

    @property
    def velocity(self):
        return self.x[7:9].copy()

    def current_box(self):
        return np.array([
            self.x[0], self.x[1], self.x[2],
            self.x[4], self.x[5], self.x[6], self.x[3],
        ])
