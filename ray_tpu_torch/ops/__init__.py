from ray_tpu_torch.ops.flash_attention import (flash_attention,
                                               flash_attention_bwd,
                                               flash_attention_bwd_reference,
                                               flash_attention_fwd,
                                               flash_attention_reference)

__all__ = ["flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_reference", "flash_attention_fwd",
           "flash_attention_reference"]
