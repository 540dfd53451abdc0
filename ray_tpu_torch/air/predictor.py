"""Predictors: checkpoint -> inference callable.

Port of ``ray_tpu/air/predictor.py``. ``TorchPredictor`` is the counterpart
of ``JaxPredictor``: the parameters go to the device once, and each
``predict`` moves a numpy batch there, runs ``apply_fn(params, batch)``
under ``torch.inference_mode()`` and returns numpy. PyTorch runs eagerly,
so there is no ``jit`` step. ``BatchPredictor`` waits for the port's
``data/``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ray_tpu_torch import DeviceLike, resolve_device
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
    return torch.as_tensor(np.asarray(tree), device=device)


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
        tree with its tensors as numpy (a dict gives a 0-d object array)."""
        with torch.inference_mode():
            out = self._apply(self.params, _to_device(data, self.device))
            return np.asarray(_tree_to_numpy(out))


def _tree_to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return to_numpy(tree)
    return tree
