"""Train layer of the port: the training step (on one device, or sharded
over a ``ray_tpu_torch.parallel`` mesh) and the optimizer factories;
``TorchTrainer`` and its worker runtime wait for the port's runtime core."""

from ray_tpu_torch.train.step import adamw, make_lm_train_step, sgd

__all__ = ["adamw", "make_lm_train_step", "sgd"]
