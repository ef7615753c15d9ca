"""Training: AdamW, the synthetic data pipeline, checkpoints in the
reference's layout, the train and serve steps on a mesh, int8 gradient
compression with error feedback and elastic re-placement.

Mirrors ``repro.train`` module for module: ``optimizer``, ``data``,
``checkpoint``, ``train_step``, ``compress`` and ``elastic``.
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
from repro_torch.train.compress import (
    compress_tree,
    crosspod_mean_compressed,
    decompress_tree,
    init_error_state,
)
from repro_torch.train.elastic import degrade_plan, remesh_live
from repro_torch.train.train_step import (
    make_serve_step,
    make_train_step,
    shardings_for_serve,
    shardings_for_train,
)

__all__ = [
    "DataConfig", "OptConfig", "apply_updates", "available_steps",
    "clean_tmp", "compress_tree", "crosspod_mean_compressed",
    "decompress_tree", "degrade_plan", "global_batch", "global_norm",
    "host_batch", "init_error_state", "init_opt_state", "keep_last",
    "load_train_tree", "lr_at", "make_serve_step", "make_train_step",
    "remesh_live", "restore_latest", "save", "shardings_for_serve",
    "shardings_for_train", "skip_to", "train_tree",
]
