"""Autoscaling. Only ``hazard`` (the preemption-hazard estimator that the
host daemons and the distributed runtime feed) is ported so far; the
autoscaler loop and its node providers wait for ROADMAP Queue 1's
framework-neutral libraries."""

from ray_tpu_torch.autoscaler.hazard import HazardEstimator

__all__ = ["HazardEstimator"]
