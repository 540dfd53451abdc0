"""Predictors: checkpoint -> inference callable.

Port of ``ray_tpu/air/predictor.py``. ``TorchPredictor`` is the counterpart
of ``JaxPredictor``: the parameters go to the device once, and each
``predict`` moves a numpy batch there, runs ``apply_fn(params, batch)``
under ``torch.inference_mode()`` and returns numpy. PyTorch runs eagerly,
so there is no ``jit`` step. A batch column whose cells are numeric arrays
of one shape (a tabular dataset's token column) is stacked on its way to
the device; ``JaxPredictor`` raises on it.

``BatchPredictor`` maps a predictor over a ``ray_tpu_torch.data`` Dataset.
It builds that predictor once per process, under a lock, and every map
task of the process shares it. The JAX package's cache is unlocked, so
each task that starts before the first build ends builds its own copy of
the weights.
"""

from __future__ import annotations

import threading
import time
import uuid
import weakref
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ray_tpu_torch import DeviceLike, observability, resolve_device
from ray_tpu_torch._private.profiling import get_profiler
from ray_tpu_torch._private.host import to_numpy
from ray_tpu_torch.air.checkpoint import Checkpoint


class Predictor:
    """Base predictor (``predict`` over numpy batches)."""

    def __init__(self, preprocessor=None):
        self.preprocessor = preprocessor

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, data) -> Any:
        if self.preprocessor is not None:
            data = self.preprocessor.transform_batch(data)
        return self._predict(data)

    def _predict(self, data) -> Any:
        raise NotImplementedError


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    from ray_tpu_torch.data.dataset import _stack_column
    return torch.as_tensor(_stack_column(tree), device=device)


class TorchPredictor(Predictor):
    """apply_fn(params, batch) over params that live on ``device``.

    ``from_checkpoint`` expects the checkpoint dict layout the Train layer
    writes: ``{"params": tree, ...}``.
    """

    def __init__(self, params: Any, apply_fn: Callable[[Any, Any], Any],
                 preprocessor=None, device: DeviceLike = None):
        super().__init__(preprocessor)
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self._apply = apply_fn

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, *,
                        apply_fn: Callable[[Any, Any], Any],
                        preprocessor=None,
                        device: DeviceLike = None) -> "TorchPredictor":
        data = checkpoint.to_dict()
        params = data.get("params", data)
        return cls(params, apply_fn, preprocessor=preprocessor, device=device)

    def _predict(self, data):
        """``np.asarray`` of the output, as ``JaxPredictor`` returns it: an
        array for a tensor; for a dict, list or tuple, ``np.asarray`` of the
        tree with its tensors as numpy (a dict gives a 0-d object array).

        The forward, from the batch's copy to the device to the numpy
        answer, is a ``serve.forward`` span in the span ring (with
        ``profiling_enabled``; edges on ``time.time_ns``) and a
        ``record_function`` range of the same name in a device trace."""
        t0_ns = time.time_ns()
        with torch.inference_mode(), record_function("serve.forward"):
            out = self._apply(self.params, _to_device(data, self.device))
            out = np.asarray(_tree_to_numpy(out))
        get_profiler().record_ns("serve.forward", "serve",
                                 observability.process_label(), t0_ns,
                                 time.time_ns())
        return out


def _tree_to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return to_numpy(tree)
    return tree


class BatchPredictor:
    """Dataset-scale inference (``batch_predictor.py``): the predictor is
    built once per process from the checkpoint and reused for every batch
    that process maps (module note)."""

    def __init__(self, checkpoint: Checkpoint, predictor_cls,
                 **predictor_kwargs):
        self.checkpoint = checkpoint
        self.predictor_cls = predictor_cls
        self.predictor_kwargs = predictor_kwargs

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, predictor_cls,
                        **kwargs) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **kwargs)

    def predict(self, dataset, *, batch_size: int = 256,
                feature_columns=None, keep_columns=None,
                prediction_column: str = "predictions"):
        slot = _slot_for(uuid.uuid4().hex, self.checkpoint,
                         self.predictor_cls, self.predictor_kwargs)

        def infer(batch):
            p = slot.get()
            if feature_columns and isinstance(batch, dict):
                features = {c: batch[c] for c in feature_columns}
            else:
                features = batch
            preds = p.predict(features)
            out = {}
            if keep_columns and isinstance(batch, dict):
                for c in keep_columns:
                    out[c] = batch[c]
            out[prediction_column] = np.asarray(preds)
            return out

        return dataset.map_batches(infer, batch_size=batch_size,
                                   batch_format="numpy")


_SLOTS: "weakref.WeakValueDictionary[str, _PredictorSlot]" = \
    weakref.WeakValueDictionary()
_SLOTS_LOCK = threading.Lock()


def _slot_for(token, checkpoint, predictor_cls, predictor_kwargs):
    """This process's slot for ``token``: the live one, or a new one."""
    with _SLOTS_LOCK:
        slot = _SLOTS.get(token)
        if slot is None:
            slot = _SLOTS[token] = _PredictorSlot(
                token, checkpoint, predictor_cls, predictor_kwargs)
        return slot


class _PredictorSlot:
    """One ``predict`` call's predictor, built on first use under a lock.
    Pickled (a map task sent to a daemon process), it comes back as that
    process's slot for the same call, so each process builds one. The
    predictor lives as long as the slot: until the mapped dataset is
    dropped."""

    def __init__(self, token: str, checkpoint, predictor_cls,
                 predictor_kwargs: Dict[str, Any]):
        self.token = token
        self._args = (checkpoint, predictor_cls, predictor_kwargs)
        self._lock = threading.Lock()
        self._predictor: Optional[Predictor] = None

    def get(self) -> Predictor:
        with self._lock:
            if self._predictor is None:
                checkpoint, predictor_cls, kwargs = self._args
                self._predictor = predictor_cls.from_checkpoint(checkpoint,
                                                                **kwargs)
            return self._predictor

    def __reduce__(self):
        return _slot_for, (self.token,) + self._args
