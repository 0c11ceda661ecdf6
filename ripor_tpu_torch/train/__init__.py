from ripor_tpu_torch.train.checkpoint import (CheckpointManager, load_params,
                                              resize_codebooks, save_params)
from ripor_tpu_torch.train.losses import (
    LOSS_FNS,
    lng_knp_margin_mse,
    lng_knp_margin_mse_and_seq2seq,
    margin_mse,
    pretrain_margin_mse,
    ranknet,
    seq2seq_ce,
)
from ripor_tpu_torch.train.trainer import (AdamW, TrainConfig, Trainer,
                                           TrainState, lr_schedule,
                                           make_optimizer, make_train_step,
                                           step_generator)

__all__ = [
    "save_params", "load_params", "CheckpointManager", "resize_codebooks",
    "LOSS_FNS", "margin_mse", "seq2seq_ce", "lng_knp_margin_mse",
    "lng_knp_margin_mse_and_seq2seq", "pretrain_margin_mse", "ranknet",
    "TrainConfig", "TrainState", "Trainer", "AdamW", "lr_schedule",
    "make_optimizer", "make_train_step", "step_generator",
]
