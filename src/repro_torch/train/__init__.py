"""Training of the port: the masked-diffusion loss, AdamW, the train step,
checkpoints and synthetic data (the reference's ``repro.train``)."""
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint  # noqa: F401
from repro_torch.train.data import DataConfig, SyntheticTextDataset  # noqa: F401
from repro_torch.train.loss import diffusion_loss  # noqa: F401
from repro_torch.train.optimizer import OptimizerConfig, adamw_update, init_opt_state  # noqa: F401
from repro_torch.train.train_step import TrainState, init_train_state, make_train_step  # noqa: F401
