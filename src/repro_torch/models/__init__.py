from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    decode_step,
    init_cache,
    init_params,
    layer_groups,
    prefill,
    train_loss,
)

__all__ = ["ModelConfig", "init_params", "init_cache", "layer_groups", "train_loss",
           "prefill", "decode_step"]
