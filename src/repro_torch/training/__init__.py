from repro_torch.training.checkpoint import WeightUpdater, restore, save
from repro_torch.training.grpo import (GRPOConfig, group_advantages,
                                       grpo_loss, pack_experience)
from repro_torch.training.loop import IterStats, RLConfig, RLTrainer
from repro_torch.training.optim import (OptConfig, OptState, adamw_update,
                                        init_opt_state)

__all__ = [
    "WeightUpdater", "restore", "save", "GRPOConfig", "group_advantages",
    "grpo_loss", "pack_experience", "IterStats", "RLConfig", "RLTrainer",
    "OptConfig", "OptState", "adamw_update", "init_opt_state",
]
