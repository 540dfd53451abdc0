from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import (CheckpointConfig, FailureConfig, Result,
                                      RunConfig, ScalingConfig)
from ray_tpu_torch.air.predictor import Predictor, TorchPredictor

__all__ = ["Checkpoint", "ScalingConfig", "RunConfig", "FailureConfig",
           "CheckpointConfig", "Result", "Predictor", "TorchPredictor"]
