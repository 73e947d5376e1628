from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params, layer_groups, train_loss

__all__ = ["ModelConfig", "init_params", "layer_groups", "train_loss"]
