"""The model kinds the benchmark runs, one module a kind.

A configuration names its kind in ``"model"``, and the harness loads
``gpubench/models/<model>.py`` by path (:func:`gpubench.cells.model_kind`),
as it loads a per-layer metric's reader. So a new kind is a new file
here and a new plain reference under ``gpubench/reference/``; no file
the harness already has changes. Each module gives:

``WIDTHS``
    ``"dims"`` where the layer widths are the configuration's ``dims``
    alone (``[num_features, hidden_channels × (num_layers − 1),
    num_classes]``); None where the kind states its widths under keys
    of its own. Every configuration's ``dims`` starts with the input
    features and ends with the classes: the harness draws the inputs
    and labels from those two.
``REFERENCE``
    the stem of the kind's plain reference,
    ``gpubench/reference/<REFERENCE>.py`` (see
    :mod:`gpubench.reference.gnn` for what that file gives).
``draw_params(cfg, seed, dev) -> list[dict]``
    the layers drawn from ``seed`` on ``dev``: a dict of float32
    tensors a layer, keyed as the reference's ``KEYS``.
``build_train(world, spec) -> None``
    what a training cell needs, set on the world once: ``world.gops``,
    the program's ``GraphOps`` under ``spec``, and whatever else the
    step takes.
``train_args(world) -> tuple``
    the arguments the program's ``train_step`` passes after the
    features into the model's forward.
``module(cfg, layers, dev)``
    the program's ``nn.Module`` holding ``layers``.
``leaves(model) -> list[torch.Tensor]``
    its parameters in the order of the reference's ``leaves``.
``register(service, name, csr, model) -> None``
    the model registered with the program's ``GNNService`` as ``name``.
``step_flops(n, nnz, cfg) -> float``
    the operations of one full-batch step on ``n`` nodes and ``nnz``
    edges, counted by :mod:`gpubench.work`'s rule.

The program (``repro_torch``) is imported only inside the functions
that build it.
"""
