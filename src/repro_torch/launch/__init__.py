"""Command-line launchers of the port: serving (``serve``), training
(``train``) and the parameter / MODEL_FLOPS accounting (``flops``).

Importing this package imports none of them, so ``python -m
repro_torch.launch.train`` runs its module once."""
