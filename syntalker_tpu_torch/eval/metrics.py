"""Gesture evaluation metrics: L1 diversity, BeatAlign, SRGR, Fréchet distance.

Counterpart of ``syntalker_tpu/eval/metrics.py``, the same numpy/scipy
code (the port keeps its own copy): L1 diversity (utils/metric.py:12-27),
BeatAlign (:54-242), SRGR (:30-52) and the Fréchet distance of
``dataloaders/data_tools.py:1556-1626``, with the onsets of
:mod:`syntalker_tpu_torch.data.audio`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
from scipy import linalg

from syntalker_tpu_torch.data import audio as A
from syntalker_tpu_torch.data.joints import BEAT_ALIGN_UPPER_JOINTS


class L1Div:
    """Mean absolute deviation of joint positions from the clip mean
    (utils/metric.py:12-27). Stateful accumulator over clips."""

    def __init__(self):
        self.counter = 0
        self.total = 0.0

    def update(self, joints: np.ndarray):
        """joints: (frames, D) positions of one clip."""
        self.counter += joints.shape[0]
        mean = joints.mean(axis=0, keepdims=True)
        self.total += float(np.sum(np.abs(joints - mean)))

    def result(self) -> float:
        return self.total / max(self.counter, 1)

    def reset(self):
        self.counter = 0
        self.total = 0.0


@dataclasses.dataclass
class BeatAligner:
    """Audio-onset / motion-beat alignment (GAHR), utils/metric.py:54-242.

    sigma=0.3, extrema order 7, normalized-speed threshold 0.3, scored over
    the upper-body joints, matching the shipped eval (train.py:157-158).
    """

    mean_velocity: np.ndarray  # (55,) per-joint dataset mean speed
    sigma: float = 0.3
    order: int = 7
    threshold: float = 0.3
    upper_body: Sequence[int] = BEAT_ALIGN_UPPER_JOINTS

    def audio_beats(self, y: np.ndarray, sr: int = 16000) -> np.ndarray:
        """Onset times (s) of a 16 kHz waveform slice."""
        return A.onset_detect_times(y, sr)

    def motion_beats(
        self, joints: np.ndarray, t_start: int, t_end: int, fps: int = 30
    ) -> List[np.ndarray]:
        """Per-joint beat frame indices (relative to t_start).

        joints: (frames, 55*3) positions. Velocity uses forward/central/
        backward differences (metric.py:99-106); beats are order-7 local
        minima of normalized speed whose speed exceeds the threshold
        (metric.py:112-127, with the frame indexing made slice-consistent).
        """
        x = joints.reshape(joints.shape[0], -1, 3)
        dt = 1.0 / fps
        vel = np.empty_like(x)
        vel[0] = (x[1] - x[0]) / dt
        vel[-1] = (x[-1] - x[-2]) / dt
        vel[1:-1] = (x[2:] - x[:-2]) / (2 * dt)
        speed = np.linalg.norm(vel, axis=2) / self.mean_velocity[None, :]

        beats = []
        for j in range(speed.shape[1]):
            s = speed[t_start:t_end, j]
            # local minima with window `order` on each side
            idx = []
            for i in range(len(s)):
                lo, hi = max(0, i - self.order), min(len(s), i + self.order + 1)
                window = s[lo:hi]
                if s[i] == window.min() and (window > s[i]).sum() == len(window) - 1:
                    if s[i] > self.threshold:
                        idx.append(i)
            beats.append(np.asarray(idx, dtype=np.int64))
        return beats

    @staticmethod
    def gahr(pose_times: np.ndarray, audio_times: np.ndarray, sigma: float) -> float:
        """Soft chamfer recall exp(-d²/2σ²) of pose beats onto audio beats
        (metric.py:205-216)."""
        if len(pose_times) == 0 or len(audio_times) == 0:
            return 0.0
        d = np.abs(pose_times[:, None] - audio_times[None, :]).min(axis=1)
        return float(np.mean(np.exp(-(d**2) / (2 * sigma**2))))

    def score(
        self,
        audio_onset_times: np.ndarray,
        motion_beats: List[np.ndarray],
        fps: int = 30,
    ) -> float:
        """Mean GAHR over the upper-body joints (metric.py:228-242)."""
        vals = []
        for j, beats in enumerate(motion_beats):
            if j not in self.upper_body:
                continue
            vals.append(self.gahr(beats / fps, audio_onset_times, self.sigma))
        return float(np.mean(vals)) if vals else 0.0


class SRGR:
    """Semantic-relevant gesture recall (utils/metric.py:30-52, legacy BEAT
    metric): per-frame joint recall within a threshold, weighted by the
    frame's semantic score (scaled by 1/0.165)."""

    def __init__(self, threshold: float = 0.1, joints: int = 47):
        self.threshold = threshold
        self.joints = joints
        self.counter = 0
        self.total = 0.0

    def update(self, results: np.ndarray, targets: np.ndarray, semantic: np.ndarray) -> float:
        results = results.reshape(-1, self.joints, 3)
        targets = targets.reshape(-1, self.joints, 3)
        semantic = semantic.reshape(-1)
        diff = np.sum(np.abs(results - targets), axis=2)
        success = np.where(diff < self.threshold, 1.0, 0.0)
        success = success * (semantic[:, None] / 0.165)
        rate = success.sum() / (success.shape[0] * success.shape[1])
        self.counter += success.shape[0]
        self.total += rate * success.shape[0]
        return float(rate)

    def result(self) -> float:
        return self.total / max(self.counter, 1)


def frechet_distance(x: np.ndarray, y: np.ndarray, eps: float = 1e-6) -> float:
    """Fréchet distance between two latent sets (N, D) / (M, D).

    float64 host computation with the eps-jitter sqrtm retry
    (data_tools.py:1615-1626): an f32 covariance on a device is not stable
    enough for the matrix square root.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    mu1, mu2 = x.mean(0), y.mean(0)
    d = x.shape[1]
    # degenerate single-sample sets: zero covariance (distance reduces to
    # the squared mean gap) instead of NaNs from ddof=1
    s1 = np.cov(x, rowvar=False) if x.shape[0] > 1 else np.zeros((d, d))
    s2 = np.cov(y, rowvar=False) if y.shape[0] > 1 else np.zeros((d, d))
    diff = mu1 - mu2
    covmean = linalg.sqrtm(s1 @ s2)
    if not np.isfinite(covmean).all():
        offset = np.eye(s1.shape[0]) * eps
        covmean = linalg.sqrtm((s1 + offset) @ (s2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean))
