"""Train layer of the port: ``TorchTrainer`` runs a training loop in GPU
train workers (``session`` inside the loop), and ``make_lm_train_step``
builds the flagship transformer's step, on one device or sharded over a
``ray_tpu_torch.parallel`` mesh, with the optimizer factories ``adamw``
and ``sgd``."""

from ray_tpu_torch.train import session
from ray_tpu_torch.train.backend_executor import (BackendExecutor,
                                                  RayTrainWorker)
from ray_tpu_torch.train.step import adamw, make_lm_train_step, sgd
from ray_tpu_torch.train.trainer import TorchTrainer

__all__ = ["TorchTrainer", "BackendExecutor", "RayTrainWorker", "session",
           "make_lm_train_step", "adamw", "sgd"]
