"""Search algorithms: variant generation over a param space.

Parity with ``python/ray/tune/search/basic_variant.py``
(``BasicVariantGenerator``) and ``variant_generator.py`` (grid resolution),
plus the ``ConcurrencyLimiter`` and ``Repeater`` wrappers from
``tune/search/``. External searcher adapters (Optuna/HyperOpt/...) are
import-gated: the libraries are not in this image.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ray_tpu_torch.tune.sample import Domain, _is_grid


def _walk(space: Dict[str, Any], path=()) -> Iterator[Tuple[Tuple, Any]]:
    for k, v in space.items():
        p = path + (k,)
        if isinstance(v, dict) and not _is_grid(v):
            yield from _walk(v, p)
        else:
            yield p, v


def _set_path(d: Dict[str, Any], path: Tuple, value: Any):
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


def _deepcopy_plain(space):
    if isinstance(space, dict):
        return {k: _deepcopy_plain(v) for k, v in space.items()}
    return space


def generate_variants(space: Dict[str, Any], num_samples: int,
                      seed: Optional[int] = None) -> Iterator[Dict[str, Any]]:
    """Cross-product every grid_search axis, then draw ``num_samples``
    samples of the remaining Domains for each grid point (matching
    reference semantics: total = num_samples x prod(grid sizes))."""
    rng = random.Random(seed)
    grid_axes: List[Tuple[Tuple, List[Any]]] = []
    sampled: List[Tuple[Tuple, Domain]] = []
    constants: List[Tuple[Tuple, Any]] = []
    for path, v in _walk(space):
        if _is_grid(v):
            grid_axes.append((path, v["grid_search"]))
        elif isinstance(v, Domain):
            sampled.append((path, v))
        else:
            constants.append((path, v))

    grid_values = [vals for _, vals in grid_axes]
    for _ in range(num_samples):
        for combo in itertools.product(*grid_values) if grid_axes else [()]:
            cfg: Dict[str, Any] = {}
            for path, v in constants:
                _set_path(cfg, path, _deepcopy_plain(v))
            for (path, _), val in zip(grid_axes, combo):
                _set_path(cfg, path, val)
            for path, dom in sampled:
                _set_path(cfg, path, dom.sample(rng))
            yield cfg


class Searcher:
    """Base searcher interface (reference ``tune/search/searcher.py``).

    ``mode=None`` means "not configured": the TrialRunner fills it from
    ``run()``'s mode. Searchers must treat ``None`` as "max"."""

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None):
        self.metric, self.mode = metric, mode

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]):
        pass

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False):
        pass


class BasicVariantGenerator(Searcher):
    """Grid + random search (reference ``basic_variant.py:BasicVariantGenerator``)."""

    def __init__(self, space: Optional[Dict[str, Any]] = None,
                 num_samples: int = 1, seed: Optional[int] = None,
                 max_concurrent: int = 0):
        super().__init__()
        self._space = space or {}
        self._num_samples = num_samples
        self._seed = seed
        self.max_concurrent = max_concurrent
        self._iter: Optional[Iterator[Dict[str, Any]]] = None

    def set_space(self, space: Optional[Dict[str, Any]],
                  num_samples: Optional[int] = None):
        """None leaves the corresponding constructor value in place."""
        if space:
            self._space = space
        if num_samples is not None:
            self._num_samples = num_samples

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._iter is None:
            self._iter = generate_variants(self._space, self._num_samples,
                                           self._seed)
        try:
            return next(self._iter)
        except StopIteration:
            return None

    def total_variants(self) -> int:
        n = self._num_samples
        for _, v in _walk(self._space):
            if _is_grid(v):
                n *= len(v["grid_search"])
        return n


class ConcurrencyLimiter(Searcher):
    """Cap in-flight suggestions (reference ``tune/search/concurrency_limiter.py``)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._live) >= self.max_concurrent:
            return None
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._live.add(trial_id)
        return cfg

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)


class Repeater(Searcher):
    """Repeat each suggestion ``repeat`` times and average the metric
    (reference ``tune/search/repeater.py``)."""

    def __init__(self, searcher: Searcher, repeat: int):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.repeat = repeat
        self._pending: List[Dict[str, Any]] = []
        self._group_of: Dict[str, int] = {}
        self._group_results: Dict[int, List[float]] = {}
        self._next_group = 0

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if not self._pending:
            cfg = self.searcher.suggest(trial_id)
            if cfg is None:
                return None
            self._next_group += 1
            self._pending = [dict(cfg) for _ in range(self.repeat)]
            self._group_results[self._next_group] = []
        self._group_of[trial_id] = self._next_group
        return self._pending.pop()

    def on_trial_complete(self, trial_id, result=None, error=False):
        gid = self._group_of.get(trial_id)
        if gid is None or result is None:
            return
        metric = self.searcher.metric or self.metric
        if metric and metric in result:
            self._group_results[gid].append(result[metric])
        if len(self._group_results[gid]) == self.repeat:
            avg = sum(self._group_results[gid]) / self.repeat
            self.searcher.on_trial_complete(
                trial_id, {metric: avg} if metric else None, error)


def _external_searcher(lib_name: str, cls_name: str):
    """Import-gated adapter factory (reference: ``tune/search/optuna``,
    ``hyperopt``, ``bayesopt`` adapters). The external libraries are not
    in this image; the native ``TPESearcher`` covers the Bayesian-search
    role without them."""

    class _Adapter(Searcher):
        def __init__(self, *a, **kw):
            # Honest in BOTH branches: the adapter is a stub regardless
            # of whether the library is installed — never send the user
            # off to pip-install something that won't help.
            hint = ("ray_tpu_torch ships a dependency-free Bayesian searcher "
                    "with the same role: ray_tpu_torch.tune.TPESearcher")
            try:
                __import__(lib_name)
            except ImportError as e:
                raise ImportError(
                    f"{cls_name} is an adapter stub in this build and the "
                    f"'{lib_name}' package is not installed anyway. "
                    f"{hint}") from e
            raise NotImplementedError(
                f"{cls_name} is an adapter stub in this build (the "
                f"'{lib_name}' package is present but not wired). {hint}")

    _Adapter.__name__ = _Adapter.__qualname__ = cls_name
    return _Adapter


OptunaSearch = _external_searcher("optuna", "OptunaSearch")
HyperOptSearch = _external_searcher("hyperopt", "HyperOptSearch")
BayesOptSearch = _external_searcher("bayes_opt", "BayesOptSearch")
