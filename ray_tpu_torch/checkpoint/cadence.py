"""Risk-tuned checkpoint cadence: ``checkpoint_frequency="auto"``.

A fixed checkpoint frequency is wrong in both directions on a
preemptible fleet: too sparse and every preemption replays a long tail
of lost steps (``restart_downtime`` in the goodput ledger), too dense
and the job pays ``ckpt_stall`` every few steps for failures that never
come.  The optimum moves with the *fleet hazard rate* — which the JAX
package's autoscaler hazard estimator measures and publishes (see
:func:`kv_hazard_source`) — so cadence must be solved, not configured.

The solver is the classic Young–Daly optimum. With

- ``M`` — mean time between failures, ``3600 / hazard_rate_per_hour``,
  less the restart cost a failure also charges (``restart_downtime``
  observed by the trainer's elastic-restart loop),
- ``delta`` — the per-checkpoint overhead the *step loop* observes
  (synchronous enqueue share plus measured ``ckpt_stall``),

the optimal wall-clock interval between checkpoints is
``T_opt = sqrt(2 * delta * M)``, and the interval in *steps* is
``T_opt / step_cost_s`` — so rising hazard or rising step cost both
shrink the step interval (checkpoint more often), while a costlier
checkpoint stretches it.  The result is clamped to
``[checkpoint_cadence_min_steps, checkpoint_cadence_max_steps]``.

:class:`CadenceController` wraps the solver with measurement (EWMA step
cost from ``session.report`` inter-arrival, EWMA checkpoint overhead
from engine-save enqueue time plus the ledger's ``ckpt_stall`` delta)
and re-solves every ``checkpoint_cadence_refresh_steps`` reports, so a
hazard change mid-run re-tunes the cadence within one refresh window.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Optional

from ray_tpu_torch._private.config import _config

logger = logging.getLogger("ray_tpu")


def solve_interval_steps(hazard_rate_per_hour: float, step_cost_s: float,
                         ckpt_cost_s: float, restart_cost_s: float = 0.0,
                         min_steps: Optional[int] = None,
                         max_steps: Optional[int] = None) -> int:
    """Young–Daly checkpoint interval, in steps (see module docstring).

    Pure and total: zero/negative hazard means "failures are not
    expected" and returns the ceiling; a degenerate step cost returns
    the ceiling too (there is no step clock to count in)."""
    if min_steps is None:
        min_steps = _config.get("checkpoint_cadence_min_steps")
    if max_steps is None:
        max_steps = _config.get("checkpoint_cadence_max_steps")
    min_steps = max(1, int(min_steps))
    max_steps = max(min_steps, int(max_steps))
    if hazard_rate_per_hour <= 0.0 or step_cost_s <= 0.0:
        return max_steps
    mtbf_s = 3600.0 / hazard_rate_per_hour
    # A failure costs its restart too: the budget an interval gambles
    # against is the useful time between failures, not the raw MTBF.
    useful_mtbf_s = max(step_cost_s, mtbf_s - max(0.0, restart_cost_s))
    t_opt_s = math.sqrt(2.0 * max(1e-3, ckpt_cost_s) * useful_mtbf_s)
    return max(min_steps, min(max_steps, round(t_opt_s / step_cost_s)))


def kv_hazard_source() -> Callable[[], float]:
    """Default fleet-hazard feed for worker sessions: the
    ``hazard_rate_floor_per_hour`` prior. The JAX package reads the rate
    the autoscaler's estimator publishes into the state KV and falls back
    to this prior when nothing was published (cold fleet, in-process
    runtime, state unreachable); this package has only the in-process
    runtime, which has no state KV, and no autoscaler yet (ROADMAP Queue
    1 item 8), so the prior is what that read would return here. Pass
    ``hazard_source=`` to feed a measured rate."""
    def read() -> float:
        return _config.get("hazard_rate_floor_per_hour")
    return read


class CadenceController:
    """Measured inputs + periodic re-solve for one training session.

    ``observe_step`` feeds the inter-report wall time, ``observe_ckpt``
    the synchronous cost of each engine save; ``interval_steps()`` is
    consulted once per reported checkpoint and re-solves every
    ``checkpoint_cadence_refresh_steps`` observed steps. Single-threaded
    by construction: all calls come from the session's train loop.
    """

    #: EWMA smoothing for measured costs — new samples count this much.
    ALPHA = 0.3

    def __init__(self, hazard_source: Optional[Callable[[], float]] = None,
                 restart_cost_s: float = 0.0,
                 min_steps: Optional[int] = None,
                 max_steps: Optional[int] = None,
                 refresh_steps: Optional[int] = None):
        self._hazard = hazard_source or kv_hazard_source()
        self.restart_cost_s = float(restart_cost_s)
        self._min = min_steps
        self._max = max_steps
        self._refresh = (refresh_steps if refresh_steps is not None
                         else _config.get("checkpoint_cadence_refresh_steps"))
        self._ewma_step_s: Optional[float] = None
        self._ewma_ckpt_s: Optional[float] = None
        self._steps_since_solve = 0
        self._saves_since_solve = 0
        self._last_stall_s = 0.0
        self.last_hazard_per_hour: Optional[float] = None
        self.last_interval: Optional[int] = None

    def observe_step(self, seconds: float) -> None:
        if seconds <= 0.0:
            return
        prev = self._ewma_step_s
        self._ewma_step_s = (seconds if prev is None
                             else prev + self.ALPHA * (seconds - prev))
        self._steps_since_solve += 1

    def observe_ckpt(self, seconds: float) -> None:
        if seconds < 0.0:
            return
        prev = self._ewma_ckpt_s
        self._ewma_ckpt_s = (seconds if prev is None
                             else prev + self.ALPHA * (seconds - prev))
        self._saves_since_solve += 1

    def _ckpt_cost_s(self) -> float:
        """Per-checkpoint overhead: the measured synchronous enqueue share
        plus the goodput ledger's ``ckpt_stall`` growth amortized over the
        saves that caused it (queue-full backpressure the enqueue timing
        alone understates)."""
        cost = self._ewma_ckpt_s if self._ewma_ckpt_s is not None else 0.1
        try:
            from ray_tpu_torch.observability import goodput
            jobs = goodput.snapshot().get("jobs") or {}
            stall = sum(float((rec.get("cats") or {}).get("ckpt_stall") or 0.0)
                        for rec in jobs.values())
        except Exception as e:  # noqa: BLE001
            logger.debug("cadence: ledger read failed: %s", e)
            return cost
        delta = stall - self._last_stall_s
        if delta > 0.0 and self._saves_since_solve > 0:
            cost += delta / self._saves_since_solve
        self._last_stall_s = max(self._last_stall_s, stall)
        return cost

    def interval_steps(self) -> int:
        """Current steps-between-checkpoints; re-solves when the refresh
        window elapsed (or on first use).  The autopilot's cluster-level
        override wins when set: its cadence policy solves the same
        Young-Daly optimum from the *fleet* hazard feed and actuates it
        through the journaled actuator layer, so a cluster whose hazard
        just spiked retunes every session at once — still clamped to
        the operator's cadence bounds here."""
        override = int(_config.get("checkpoint_cadence_autopilot_steps"))
        if override > 0:
            lo = max(1, int(self._min
                            if self._min is not None
                            else _config.get("checkpoint_cadence_min_steps")))
            hi = max(lo, int(self._max
                             if self._max is not None
                             else _config.get("checkpoint_cadence_max_steps")))
            self.last_interval = max(lo, min(hi, override))
            return self.last_interval
        if (self.last_interval is not None
                and self._steps_since_solve < max(1, self._refresh)):
            return self.last_interval
        hazard = max(0.0, float(self._hazard()))
        interval = solve_interval_steps(
            hazard,
            self._ewma_step_s if self._ewma_step_s is not None else 1.0,
            self._ckpt_cost_s(),
            restart_cost_s=self.restart_cost_s,
            min_steps=self._min, max_steps=self._max)
        if interval != self.last_interval:
            logger.info("checkpoint cadence: every %d step(s) (hazard "
                        "%.2f/h, step %.3fs, ckpt %.3fs)", interval,
                        hazard, self._ewma_step_s or 1.0,
                        self._ewma_ckpt_s or 0.1)
        self.last_hazard_per_hour = hazard
        self.last_interval = interval
        self._steps_since_solve = 0
        self._saves_since_solve = 0
        return interval
