"""Unified retry / backoff / deadline policy + per-peer circuit breaker.

Every retry loop in the runtime (RpcClient connect, StateClient reconnect
and call retry, heartbeat misses, task resubmission, borrow-protocol calls)
goes through :class:`BackoffPolicy` instead of hand-rolled
``time.sleep``-in-a-loop (raylint R7 flags those). The policy is the
composition the reference spreads across ``ray_config_def.h`` knobs:

- exponential backoff with **full jitter** (AWS-style: ``delay =
  uniform(0, min(max, base * mult**attempt))``) so synchronized failures
  don't retry in lockstep;
- an optional **per-attempt timeout** (each RPC attempt gets at most this);
- an overall **deadline budget** — retries stop when the budget is spent,
  not after a magic attempt count;
- **retryable-error classification**: connection/timeout faults retry,
  remote handler errors (``RpcRemoteError``) never do.

:class:`CircuitBreaker` / :class:`BreakerBoard` add the per-peer fail-fast
layer: after ``failure_threshold`` consecutive failures a peer's breaker
opens and callers shed load immediately instead of timing out every push;
after ``reset_s`` one probe is allowed through (half-open) and its outcome
closes or re-opens the breaker.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional, Tuple, Type

from ray_tpu_torch._private.config import _config

__all__ = ["BackoffPolicy", "BackoffState", "CircuitBreaker", "BreakerBoard",
           "retry_call", "RETRYABLE_DEFAULT"]

#: Errors that are retryable by default: transport-level faults. Notably
#: NOT RpcRemoteError (the peer's handler ran and raised — retrying would
#: re-execute side effects) — it subclasses RuntimeError, not OSError.
RETRYABLE_DEFAULT: Tuple[Type[BaseException], ...] = (
    ConnectionError, TimeoutError, OSError)


class BackoffPolicy:
    """Immutable retry policy; ``start()`` yields the per-sequence state.

    ``None`` parameters fall back to the ``backoff_*`` config knobs at
    ``start()`` time, so env/system-config overrides apply without
    rebuilding policies. ``deadline_s=0`` / ``max_attempts=0`` mean
    unlimited; at least one should be bounded in production paths.
    """

    def __init__(self, base_s: Optional[float] = None,
                 max_s: Optional[float] = None,
                 multiplier: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 max_attempts: int = 0,
                 attempt_timeout_s: Optional[float] = None,
                 retryable: Tuple[Type[BaseException], ...] = RETRYABLE_DEFAULT,
                 jitter: bool = True,
                 seed: Optional[int] = None,
                 label: str = ""):
        self.base_s = base_s
        self.max_s = max_s
        self.multiplier = multiplier
        self.deadline_s = deadline_s
        self.max_attempts = max_attempts
        self.attempt_timeout_s = attempt_timeout_s
        self.retryable = retryable
        self.jitter = jitter
        self.seed = seed
        self.label = label  # metrics site tag for backoff_retries_total

    def classify(self, exc: BaseException) -> bool:
        """True when ``exc`` should be retried under this policy."""
        return isinstance(exc, self.retryable)

    def _resolved(self):
        base = (self.base_s if self.base_s is not None
                else _config.get("backoff_base_ms") / 1000.0)
        cap = (self.max_s if self.max_s is not None
               else _config.get("backoff_max_ms") / 1000.0)
        mult = (self.multiplier if self.multiplier is not None
                else _config.get("backoff_multiplier"))
        deadline = (self.deadline_s if self.deadline_s is not None
                    else _config.get("backoff_deadline_s"))
        return base, cap, mult, deadline

    def delay_for(self, attempt: int,
                  rng: Optional[random.Random] = None) -> float:
        """Backoff delay before retry number ``attempt`` (0-based), with
        full jitter. Usable standalone (e.g. Timer-based resubmission)."""
        base, cap, mult, _ = self._resolved()
        upper = min(cap, base * (mult ** attempt))
        if not self.jitter:
            return upper
        return (rng or _rng).uniform(0.0, upper)

    def start(self, clock: Callable[[], float] = time.monotonic
              ) -> "BackoffState":
        base, cap, mult, deadline = self._resolved()
        return BackoffState(self, base, cap, mult, deadline, clock)


class BackoffState:
    """One retry sequence: tracks attempts and the deadline budget.

    Loop shape::

        state = policy.start()
        while True:
            try:
                return do_attempt(timeout=state.attempt_timeout())
            except Exception as e:
                if not policy.classify(e) or not state.sleep():
                    raise
    """

    def __init__(self, policy: BackoffPolicy, base: float, cap: float,
                 mult: float, deadline: float,
                 clock: Callable[[], float]):
        self.policy = policy
        self._base = base
        self._cap = cap
        self._mult = mult
        self._clock = clock
        self._started = clock()
        self._deadline = (self._started + deadline) if deadline > 0 else None
        self.attempt = 0  # completed (failed) attempts so far
        self.site = policy.label  # overridable per-sequence metrics tag
        self._rng = (random.Random(policy.seed)
                     if policy.seed is not None else _rng)

    def elapsed(self) -> float:
        return self._clock() - self._started

    def remaining(self) -> Optional[float]:
        """Seconds left in the deadline budget; None = unbounded."""
        if self._deadline is None:
            return None
        return self._deadline - self._clock()

    def attempt_timeout(self) -> Optional[float]:
        """Timeout for the NEXT attempt: min(per-attempt cap, remaining
        budget); None = unbounded."""
        rem = self.remaining()
        per = self.policy.attempt_timeout_s
        if per is None:
            return rem
        if rem is None:
            return per
        return min(per, rem)

    def next_delay(self) -> Optional[float]:
        """Delay before the next retry, or None when the budget (deadline
        or max_attempts) is exhausted. Advances the attempt counter."""
        self.attempt += 1
        if (self.policy.max_attempts
                and self.attempt >= self.policy.max_attempts):
            return None
        upper = min(self._cap, self._base * (self._mult ** (self.attempt - 1)))
        delay = (self._rng.uniform(0.0, upper) if self.policy.jitter
                 else upper)
        rem = self.remaining()
        if rem is not None:
            if rem <= 0:
                return None
            delay = min(delay, rem)  # never sleep past the deadline
        _count_retry(self.site or "unlabeled")
        return delay

    def sleep(self, sleep: Callable[[float], None] = time.sleep) -> bool:
        """next_delay() + sleep. False when the budget is exhausted (the
        caller should give up and re-raise)."""
        delay = self.next_delay()
        if delay is None:
            return False
        if delay > 0:
            sleep(delay)
        return True


_rng = random.Random()

_counter_lock = threading.Lock()
_retry_counter = None  # raylint: guarded-by(_counter_lock)


def _count_retry(site: str):
    # Lazy singleton (metrics must not be a hard import here: backoff is
    # used by the wire layer during bootstrap). One counter, tagged by
    # call site, covers every BackoffPolicy loop in the runtime.  Created
    # under _counter_lock: two first-retry threads racing here used to
    # mint two Counters and trip the registry's duplicate check.
    global _retry_counter
    try:
        from ray_tpu_torch.util.metrics import Counter
        with _counter_lock:
            c = _retry_counter
            if c is None:
                c = _retry_counter = Counter(
                    "backoff_retries_total",
                    "retry attempts by call site", tag_keys=("site",))
        c.inc(tags={"site": site})
    except Exception:  # raylint: allow(swallow) metrics must never break a retry loop
        pass


def retry_call(fn: Callable[[Optional[float]], object],
               policy: Optional[BackoffPolicy] = None, *,
               on_retry: Optional[Callable[[int, BaseException], None]] = None,
               sleep: Callable[[float], None] = time.sleep):
    """Run ``fn(attempt_timeout)`` under ``policy``, retrying retryable
    failures until the budget is spent (the final error re-raises).
    ``fn`` receives the per-attempt timeout (None = unbounded) and may
    ignore it. ``on_retry(attempt, exc)`` fires before each backoff sleep."""
    policy = policy or BackoffPolicy()
    state = policy.start()
    if not state.site:
        state.site = getattr(fn, "__qualname__", "") or "fn"
    while True:
        try:
            return fn(state.attempt_timeout())
        except BaseException as e:  # noqa: BLE001 — classified below
            if not policy.classify(e):
                raise
            if on_retry is not None:
                try:
                    on_retry(state.attempt, e)
                except Exception:  # raylint: allow(swallow) observer hook must not break the retry
                    pass
            if not state.sleep(sleep):
                raise


# -- circuit breaker ----------------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Per-peer fail-fast: CLOSED → (N consecutive failures) → OPEN →
    (reset_s elapses) → HALF_OPEN (one probe) → CLOSED on success, OPEN on
    failure. Thread-safe; all transitions under one lock."""

    def __init__(self, failure_threshold: Optional[int] = None,
                 reset_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._threshold = (failure_threshold if failure_threshold is not None
                           else _config.get("circuit_failure_threshold"))
        self._reset_s = (reset_s if reset_s is not None
                         else _config.get("circuit_reset_s"))
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._state = CLOSED
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def state_code(self) -> int:
        """0=closed 1=half_open 2=open — for metrics gauges."""
        return _STATE_CODE[self.state]

    def _maybe_half_open(self):
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self._reset_s):
            self._state = HALF_OPEN
            self._probing = False

    def allow(self) -> bool:
        """May traffic go to this peer now? In HALF_OPEN exactly one caller
        gets True (the probe) until its outcome is recorded."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._state = CLOSED
            self._probing = False

    def record_failure(self) -> bool:
        """Record one failure; True when this transition OPENED the
        breaker (edge-triggered, for logging/metrics hooks)."""
        with self._lock:
            self._maybe_half_open()
            self._failures += 1
            if self._state == HALF_OPEN:
                # failed probe: straight back to OPEN, restart the clock
                self._state = OPEN
                self._opened_at = self._clock()
                self._probing = False
                return True
            if self._state == CLOSED and self._failures >= self._threshold:
                self._state = OPEN
                self._opened_at = self._clock()
                return True
            return False


class BreakerBoard:
    """Circuit breakers keyed by peer address, created on first use.

    ``on_open(addr)`` fires (outside the board lock) whenever a peer's
    breaker transitions to OPEN — the distributed runtime uses it to mark
    the address suspect for scheduling.
    """

    def __init__(self, failure_threshold: Optional[int] = None,
                 reset_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_open: Optional[Callable[[str], None]] = None):
        self._threshold = failure_threshold
        self._reset_s = reset_s
        self._clock = clock
        self._on_open = on_open
        self._lock = threading.Lock()
        self._breakers = {}  # raylint: guarded-by(self._lock)

    def get(self, addr: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(addr)
            if br is None:
                br = CircuitBreaker(self._threshold, self._reset_s,
                                    self._clock)
                self._breakers[addr] = br
            return br

    def allow(self, addr: str) -> bool:
        return self.get(addr).allow()

    def record_success(self, addr: str):
        self.get(addr).record_success()

    def record_failure(self, addr: str):
        if self.get(addr).record_failure() and self._on_open is not None:
            try:
                self._on_open(addr)
            except Exception:  # raylint: allow(swallow) observer hook must not break failure accounting
                pass

    def drop(self, addr: str):
        with self._lock:
            self._breakers.pop(addr, None)

    def snapshot(self):
        """{addr: state_code} for metrics export."""
        with self._lock:
            items = list(self._breakers.items())
        return {addr: br.state_code() for addr, br in items}
