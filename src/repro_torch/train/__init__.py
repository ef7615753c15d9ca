"""Dense training on one card: AdamW, the synthetic data pipeline,
checkpoints in the reference's layout, and the train step.

Mirrors ``repro.train`` for ``optimizer``, ``data``, ``checkpoint`` and
``train_step``; gradient compression and elastic resharding
(``compress``, ``elastic``) wait for ROADMAP item 13d.
"""
from repro_torch.train.checkpoint import (
    available_steps,
    clean_tmp,
    keep_last,
    load_train_tree,
    restore_latest,
    save,
    train_tree,
)
from repro_torch.train.data import (
    DataConfig,
    global_batch,
    host_batch,
    skip_to,
)
from repro_torch.train.optimizer import (
    OptConfig,
    apply_updates,
    global_norm,
    init_opt_state,
    lr_at,
)
from repro_torch.train.train_step import make_train_step

__all__ = [
    "DataConfig", "OptConfig", "apply_updates", "available_steps",
    "clean_tmp", "global_batch", "global_norm", "host_batch",
    "init_opt_state", "keep_last", "load_train_tree", "lr_at",
    "make_train_step", "restore_latest", "save", "skip_to", "train_tree",
]
