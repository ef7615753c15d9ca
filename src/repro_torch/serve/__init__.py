"""Serving layer: LM decode batching + sparse-operator serving.

Two serving stacks live here:

* :mod:`repro_torch.serve.batching` — vLLM-style continuous batching
  for a dense LM decode path;
* :mod:`repro_torch.serve.registry` / :mod:`repro_torch.serve.engine` /
  :mod:`repro_torch.serve.gnn_service` — multi-tenant sparse-operator
  serving over a plan registry: register a graph once (tune +
  preprocess + warm), then serve SpMM/SDDMM/GNN-forward requests
  through panel-bucketed applies of K1–K4, with the degradation ladder
  of :mod:`repro_torch.serve.resilience` and the seeded faults of
  :mod:`repro_torch.serve.faults`.

Lazy exports (PEP 562) so ``import repro_torch.serve`` stays cheap.
"""
from __future__ import annotations

_LAZY = {
    "AdmissionError": "repro_torch.serve.engine",
    "CircuitBreaker": "repro_torch.serve.resilience",
    "ContinuousBatcher": "repro_torch.serve.batching",
    "DeadlineExceeded": "repro_torch.serve.resilience",
    "ExecutionFailed": "repro_torch.serve.resilience",
    "FaultPlan": "repro_torch.serve.faults",
    "FaultRule": "repro_torch.serve.faults",
    "GNNService": "repro_torch.serve.gnn_service",
    "GraphRegistry": "repro_torch.serve.registry",
    "InjectedFault": "repro_torch.serve.faults",
    "MemoryPressure": "repro_torch.obs.memstat",
    "RegisteredGraph": "repro_torch.serve.registry",
    "Request": "repro_torch.serve.batching",
    "ResiliencePolicy": "repro_torch.serve.resilience",
    "ServeError": "repro_torch.serve.resilience",
    "SimulatedResourceExhausted": "repro_torch.serve.faults",
    "SparseEngine": "repro_torch.serve.engine",
    "SparseRequest": "repro_torch.serve.engine",
    "as_csr": "repro_torch.serve.registry",
    "corrupt_cache_entry": "repro_torch.serve.faults",
    "run_to_completion": "repro_torch.serve.batching",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'repro_torch.serve' has no attribute {name!r}")
