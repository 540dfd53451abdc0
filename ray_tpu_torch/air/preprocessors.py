"""Dataset preprocessors.

Parity with ``python/ray/data/preprocessors/`` (StandardScaler,
MinMaxScaler, LabelEncoder, OneHotEncoder, SimpleImputer, Chain;
base class ``ray/data/preprocessor.py``): fit on a Dataset, transform
Datasets or batches. Fitted state is plain numpy so a preprocessor
travels inside a Checkpoint to serving (``air/checkpoint.py`` flow).

Port of ``ray_tpu/air/preprocessors.py``, unchanged (pure numpy).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class Preprocessor:
    """fit/transform over dict-of-columns batches (arrow-block analogue)."""

    _fitted = False

    def fit(self, dataset) -> "Preprocessor":
        self._fit(dataset)
        self._fitted = True
        return self

    def transform(self, dataset):
        if not self._fitted and self.fit_required():
            raise RuntimeError(f"{type(self).__name__} not fitted")
        return dataset.map_batches(self.transform_batch,
                                   batch_format="numpy")

    def fit_transform(self, dataset):
        return self.fit(dataset).transform(dataset)

    def fit_required(self) -> bool:
        return True

    # subclass API
    def _fit(self, dataset) -> None:
        raise NotImplementedError

    def transform_batch(self, batch: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
        raise NotImplementedError


def _column_arrays(dataset, columns: List[str]) -> Dict[str, np.ndarray]:
    cols: Dict[str, List[np.ndarray]] = {c: [] for c in columns}
    for batch in dataset.iter_batches(batch_format="numpy"):
        for c in columns:
            cols[c].append(np.asarray(batch[c]))
    return {c: np.concatenate(v) for c, v in cols.items()}


class StandardScaler(Preprocessor):
    """Zero-mean unit-variance per column."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, Any] = {}

    def _fit(self, dataset):
        arrays = _column_arrays(dataset, self.columns)
        self.stats_ = {
            c: (float(v.mean()), float(v.std()) or 1.0)
            for c, v in arrays.items()}

    def transform_batch(self, batch):
        out = dict(batch)
        for c, (mean, std) in self.stats_.items():
            out[c] = (np.asarray(batch[c]) - mean) / std
        return out


class MinMaxScaler(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, Any] = {}

    def _fit(self, dataset):
        arrays = _column_arrays(dataset, self.columns)
        self.stats_ = {
            c: (float(v.min()), float(v.max()))
            for c, v in arrays.items()}

    def transform_batch(self, batch):
        out = dict(batch)
        for c, (lo, hi) in self.stats_.items():
            span = (hi - lo) or 1.0
            out[c] = (np.asarray(batch[c]) - lo) / span
        return out


class LabelEncoder(Preprocessor):
    """String/any labels -> dense int codes."""

    def __init__(self, label_column: str):
        self.label_column = label_column
        self.classes_: Dict[Any, int] = {}

    def _fit(self, dataset):
        values = _column_arrays(dataset, [self.label_column])[
            self.label_column]
        self.classes_ = {v: i for i, v in
                         enumerate(sorted(set(values.tolist())))}

    def transform_batch(self, batch):
        out = dict(batch)
        out[self.label_column] = np.array(
            [self.classes_[v] for v in
             np.asarray(batch[self.label_column]).tolist()],
            dtype=np.int64)
        return out


class OneHotEncoder(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = columns
        self.categories_: Dict[str, Dict[Any, int]] = {}

    def _fit(self, dataset):
        arrays = _column_arrays(dataset, self.columns)
        self.categories_ = {
            c: {v: i for i, v in enumerate(sorted(set(a.tolist())))}
            for c, a in arrays.items()}

    def transform_batch(self, batch):
        out = dict(batch)
        for c, cats in self.categories_.items():
            values = np.asarray(batch[c]).tolist()
            onehot = np.zeros((len(values), len(cats)), np.float32)
            for i, v in enumerate(values):
                idx = cats.get(v)
                if idx is not None:
                    onehot[i, idx] = 1.0
            out.pop(c)
            out[f"{c}_onehot"] = onehot
        return out


class SimpleImputer(Preprocessor):
    """NaNs -> mean (numeric columns)."""

    def __init__(self, columns: List[str], strategy: str = "mean"):
        if strategy not in ("mean", "constant"):
            raise ValueError(f"unsupported strategy {strategy!r}")
        self.columns = columns
        self.strategy = strategy
        self.fill_value = 0.0
        self.stats_: Dict[str, float] = {}

    def _fit(self, dataset):
        arrays = _column_arrays(dataset, self.columns)
        for c, v in arrays.items():
            self.stats_[c] = (float(np.nanmean(v))
                              if self.strategy == "mean"
                              else self.fill_value)

    def transform_batch(self, batch):
        out = dict(batch)
        for c, fill in self.stats_.items():
            v = np.asarray(batch[c], np.float64).copy()
            v[np.isnan(v)] = fill
            out[c] = v
        return out


class Chain(Preprocessor):
    """Sequential composition; fit runs left to right on the running
    transform (reference: ``preprocessors/chain.py``)."""

    def __init__(self, *preprocessors: Preprocessor):
        self.preprocessors = list(preprocessors)

    def fit(self, dataset) -> "Chain":
        ds = dataset
        for p in self.preprocessors:
            p.fit(ds)
            ds = p.transform(ds)
        self._fitted = True
        return self

    def _fit(self, dataset):  # pragma: no cover — fit() overridden
        raise AssertionError

    def transform_batch(self, batch):
        for p in self.preprocessors:
            batch = p.transform_batch(batch)
        return batch


class BatchMapper(Preprocessor):
    """Stateless user function as a preprocessor."""

    def __init__(self, fn):
        self.fn = fn
        self._fitted = True

    def fit_required(self) -> bool:
        return False

    def _fit(self, dataset):
        pass

    def transform_batch(self, batch):
        return self.fn(batch)
