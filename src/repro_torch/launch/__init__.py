"""Command-line launchers of the port: serving (``serve``), training
(``train``), the parameter / MODEL_FLOPS accounting (``flops``), the
production meshes (``mesh``) and the reports: the op counter
(``hlo_analysis``), the dry run of every cell (``dryrun``) and its
tables (``report``).

Importing this package imports none of them, so ``python -m
repro_torch.launch.train`` runs its module once."""
