"""Train layer of the port. This slice has the single-device training step
and the optimizer factories; ``TorchTrainer`` and its worker runtime wait
for the port's runtime core."""

from ray_tpu_torch.train.step import adamw, make_lm_train_step, sgd

__all__ = ["adamw", "make_lm_train_step", "sgd"]
