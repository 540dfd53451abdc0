from ray_tpu_torch.models import resnet, transformer
from ray_tpu_torch.models.transformer import TransformerConfig

__all__ = ["transformer", "resnet", "TransformerConfig"]
