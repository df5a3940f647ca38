"""Timestep schedule samplers (reference diffusion/resample.py:1-157): a
copy of rohm_tpu/train/resample.py, numpy only.

Only the UniformSampler is ever selected by the reference training loops
(schedule_sampler_type='uniform', training_loop_trajnet.py:57-58), and the
port's train step draws that uniform t on the device from its
torch.Generator (train/steps.py); the loss-second-moment resampler exists
behind the same factory for completeness. The reference's
dist.all_gather sync (resample.py:86-107) maps to nothing: one process
drives the training.
"""

from __future__ import annotations

import numpy as np


class ScheduleSampler:
    def weights(self) -> np.ndarray:
        raise NotImplementedError

    def sample(self, batch_size: int, rng: np.random.Generator):
        """Importance-sample timesteps; returns (t [bs] int32, weights [bs])."""
        w = self.weights()
        p = w / w.sum()
        t = rng.choice(len(p), size=batch_size, p=p)
        weights = 1.0 / (len(p) * p[t])
        return t.astype(np.int32), weights.astype(np.float32)

    def update_with_losses(self, t: np.ndarray, losses: np.ndarray) -> None:
        pass


class UniformSampler(ScheduleSampler):
    def __init__(self, num_timesteps: int):
        self._w = np.ones(num_timesteps, np.float64)

    def weights(self) -> np.ndarray:
        return self._w


class LossSecondMomentResampler(ScheduleSampler):
    """Importance-sample t proportional to sqrt(E[loss^2]) with uniform mixing
    (reference resample.py:110-157)."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10, uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros((num_timesteps, history_per_term), np.float64)
        self._loss_counts = np.zeros(num_timesteps, np.int64)

    def _warmed_up(self) -> bool:
        return (self._loss_counts == self.history_per_term).all()

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones(self.num_timesteps, np.float64)
        w = np.sqrt(np.mean(self._loss_history**2, axis=-1))
        w /= w.sum()
        w *= 1 - self.uniform_prob
        w += self.uniform_prob / len(w)
        return w

    def update_with_losses(self, t: np.ndarray, losses: np.ndarray) -> None:
        for ti, li in zip(np.asarray(t).ravel(), np.asarray(losses).ravel()):
            if self._loss_counts[ti] == self.history_per_term:
                self._loss_history[ti, :-1] = self._loss_history[ti, 1:]
                self._loss_history[ti, -1] = li
            else:
                self._loss_history[ti, self._loss_counts[ti]] = li
                self._loss_counts[ti] += 1


def create_named_schedule_sampler(name: str, num_timesteps: int) -> ScheduleSampler:
    """Factory matching reference resample.py:11-28."""
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")
