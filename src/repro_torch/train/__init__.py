from repro_torch.train.optimizer import AdamWState, adamw_init, adamw_update
from repro_torch.train.trainstep import make_train_step

__all__ = ["AdamWState", "adamw_init", "adamw_update", "make_train_step"]
