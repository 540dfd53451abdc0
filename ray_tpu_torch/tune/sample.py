"""Search-space primitives.

Parity with the reference's ``python/ray/tune/search/sample.py`` (Domain
classes) and ``tune.grid_search``: a config dict may contain ``Domain``
values (sampled per trial) and ``grid_search`` markers (cross-producted
across trials).
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Sequence


class Domain:
    """A sampleable value in a param space."""

    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False):
        if log and lower <= 0:
            raise ValueError("loguniform requires lower > 0")
        self.lower, self.upper, self.log = lower, upper, log

    def sample(self, rng: random.Random) -> float:
        if self.log:
            import math
            return math.exp(rng.uniform(math.log(self.lower),
                                        math.log(self.upper)))
        return rng.uniform(self.lower, self.upper)

    def quantized(self, q: float) -> "Quantized":
        return Quantized(self, q)


class Integer(Domain):
    def __init__(self, lower: int, upper: int, log: bool = False):
        self.lower, self.upper, self.log = lower, upper, log

    def sample(self, rng: random.Random) -> int:
        if self.log:
            import math
            return int(round(math.exp(rng.uniform(math.log(self.lower),
                                                  math.log(self.upper)))))
        return rng.randint(self.lower, self.upper - 1)


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng: random.Random) -> Any:
        return rng.choice(self.categories)


class Normal(Domain):
    def __init__(self, mean: float = 0.0, sd: float = 1.0):
        self.mean, self.sd = mean, sd

    def sample(self, rng: random.Random) -> float:
        return rng.gauss(self.mean, self.sd)


class Function(Domain):
    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn

    def sample(self, rng: random.Random) -> Any:
        try:
            return self.fn(None)  # reference passes a `spec` argument
        except TypeError:
            return self.fn()


class Quantized(Domain):
    def __init__(self, inner: Domain, q: float):
        self.inner, self.q = inner, q

    def sample(self, rng: random.Random) -> float:
        v = self.inner.sample(rng)
        return round(v / self.q) * self.q


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def quniform(lower: float, upper: float, q: float) -> Quantized:
    return Quantized(Float(lower, upper), q)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def qloguniform(lower: float, upper: float, q: float) -> Quantized:
    return Quantized(Float(lower, upper, log=True), q)


def randn(mean: float = 0.0, sd: float = 1.0) -> Normal:
    return Normal(mean, sd)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def lograndint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper, log=True)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def sample_from(fn: Callable[[], Any]) -> Function:
    return Function(fn)


def grid_search(values: List[Any]) -> Dict[str, List[Any]]:
    """Marker dict, cross-producted by the variant generator
    (reference: ``tune/search/variant_generator.py``)."""
    return {"grid_search": list(values)}


def _is_grid(v: Any) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"grid_search"}
