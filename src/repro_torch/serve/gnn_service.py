"""GNN inference serving: trained models scored through the engine.

Registers a trained GCN or AGNN (the port's :class:`~repro_torch.models
.gnn.GCN` / :class:`~repro_torch.models.gnn.AGNN` modules, e.g. carried
from the reference package's parameters by
:func:`~repro_torch.models.convert.gcn_params_from_jax`) with its graph
and serves node-scoring requests end to end through the panel-bucketed
:class:`~repro_torch.serve.engine.SparseEngine` — every sparse operation
in the forward pass (feature-aggregation SpMM, attention SDDMM) is
admitted as an engine request, so concurrent scoring requests against
the same model (or different models sharing a graph) batch into shared
panel executions layer by layer.

* **GCN** — the symmetric-normalized adjacency values are baked into
  the registered plan (:func:`repro_torch.serve.registry.as_csr`), so
  each layer is one engine SpMM of ``H @ W``.
* **AGNN** — each layer runs an engine SDDMM for the attention scores,
  a host-side edge softmax (:func:`repro_torch.models.gnn.edge_softmax`,
  on the device), then an engine SpMM carrying the attention weights as
  per-request ``edge_vals`` (the revalue path — the plan's pattern is
  the shared asset, the values arrive with the request).

The dense per-layer projections (``h @ W``) are plain torch matmuls —
the sparse operators are the scarce, plan-bound resource the engine
amortizes; dense GEMM needs no bucketing.

A flush is a ``gnn_service.flush`` span (:mod:`repro_torch.obs.trace`,
also on the card's clock) holding, per layer, ``gnn_service.attention``
(normalisation, the SDDMM engine flush, the softmax),
``gnn_service.aggregate`` (the SpMM engine flush) and
``gnn_service.dense`` (the projections and activations).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.obs.trace import span
from repro_torch.serve.engine import SparseEngine
from repro_torch.serve.registry import as_csr
from repro_torch.serve.resilience import ServeError
from repro_torch.sparse.matrix import SparseCSR


@dataclasses.dataclass
class _Model:
    kind: str                   # "gcn" | "agnn"
    graph: str                  # registry name of the serving graph
    params: list                # per layer {"w": (d_in, d_out)[, "beta"]}
    m: int
    edge_row: torch.Tensor | None = None  # AGNN softmax segments (int64)


@dataclasses.dataclass
class _Scoring:
    rid: int
    model: str
    h: torch.Tensor
    node_ids: torch.Tensor | None
    error: ServeError | None = None   # first failed layer op, if any


class GNNService:
    """Model registry + layer-wise scoring scheduler over one engine."""

    def __init__(self, engine: SparseEngine):
        self.engine = engine
        self.device = torch.device(engine.registry.device)
        self._models: dict[str, _Model] = {}
        self._pending: list[_Scoring] = []
        self._next_rid = 0

    # -------------------------------------------------------- register ---
    def _weights(self, model) -> list[dict]:
        """Per-layer ``{"w"[, "beta"]}`` tensors of a GCN/AGNN module,
        detached and on the serving device."""
        betas = getattr(model, "betas", None)
        out = []
        for i, w in enumerate(model.weights):
            layer = {"w": w.detach().to(self.device)}
            if betas is not None:
                layer["beta"] = betas[i].detach().to(self.device)
            out.append(layer)
        return out

    def register_gcn(self, name: str, a: SparseCSR, model, *,
                     norm_edge_vals: np.ndarray | None = None,
                     mesh=None) -> str:
        """Register a trained :class:`~repro_torch.models.gnn.GCN`.
        ``norm_edge_vals`` defaults to the symmetric normalization
        D^-1/2 A D^-1/2; ``mesh`` (a
        :class:`~repro_torch.dist.sparse.ShardMesh`) serves the
        aggregation through the sharded apply."""
        from repro_torch.models.gnn import gcn_norm_edges

        ev = (gcn_norm_edges(a) if norm_edge_vals is None
              else np.asarray(norm_edge_vals, np.float32))
        graph = self.engine.registry.register(
            as_csr(a, ev), name=f"{name}::graph", ops=("spmm",), mesh=mesh)
        self._models[name] = _Model("gcn", graph, self._weights(model), a.m)
        return name

    def register_agnn(self, name: str, a: SparseCSR, model) -> str:
        """Register a trained :class:`~repro_torch.models.gnn.AGNN`;
        attention runs through engine SDDMM + per-request ``edge_vals``
        SpMM."""
        graph = self.engine.registry.register(
            a, name=f"{name}::graph", ops=("spmm", "sddmm"))
        rows, _, _ = a.to_coo()
        self._models[name] = _Model(
            "agnn", graph, self._weights(model), a.m,
            edge_row=torch.from_numpy(rows.astype(np.int64)).to(
                self.device))
        return name

    # ----------------------------------------------------------- score ---
    def submit(self, model: str, feats, node_ids=None) -> int:
        """Admit one node-scoring request (forward over ``feats``,
        scores returned for ``node_ids`` — all nodes when None)."""
        if model not in self._models:
            raise KeyError(f"unknown model {model!r}")
        m = self._models[model]
        feats = torch.as_tensor(feats, device=self.device)
        if feats.ndim != 2 or feats.shape[0] != m.m:
            raise ValueError(f"feats must be ({m.m}, d), got "
                             f"{tuple(feats.shape)}")
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append(_Scoring(
            rid, model, feats,
            None if node_ids is None else torch.as_tensor(
                node_ids, device=self.device)))
        return rid

    def _flush_engine(self, tickets: dict) -> dict:
        """Flush the shared engine, keeping only this service's tickets
        and redepositing any foreign submitters' results."""
        out = self.engine.flush()
        mine = {t: out.pop(t) for t in tickets.values() if t in out}
        self.engine.redeposit(out)
        return mine

    def flush(self) -> dict[int, torch.Tensor | ServeError]:
        """Run all pending scoring requests layer-by-layer; each layer
        is one engine flush (two for AGNN: SDDMM, then valued SpMM), so
        requests share panel executions — foreign requests queued on
        the shared engine are served too, their results redeposited for
        their submitters.

        A scoring whose layer op comes back as a typed
        :class:`~repro_torch.serve.resilience.ServeError` fails alone: it
        stops riding later layers, its slot in the returned dict holds
        the error, and every other scoring completes normally.
        """
        pending, self._pending = self._pending, []
        if not pending:
            return {}
        with span("gnn_service.flush", self.device, requests=len(pending)):
            depth = max(len(self._models[s.model].params) for s in pending)
            for layer in range(depth):
                self._layer(pending, layer)
        return {s.rid: (s.error if s.error is not None
                        else s.h if s.node_ids is None
                        else s.h[s.node_ids])
                for s in pending}

    def _layer(self, pending: list[_Scoring], layer: int) -> None:
        """One layer of every live scoring in ``pending``: the attention
        round (AGNN), the aggregation round, the projections."""
        live = [s for s in pending if s.error is None
                and layer < len(self._models[s.model].params)]
        gcn = [s for s in live if self._models[s.model].kind == "gcn"]
        agnn = [s for s in live if self._models[s.model].kind == "agnn"]
        att = {}
        if agnn:   # attention round first: SDDMM on normalized h
            with span("gnn_service.attention"):
                att = self._attention(agnn, layer)
            agnn = [s for s in agnn if s.error is None]
        b = {}
        if gcn:
            with span("gnn_service.dense"):
                for s in gcn:
                    b[s.rid] = s.h @ self._models[s.model].params[layer]["w"]
        with span("gnn_service.aggregate"):
            tickets = {}
            for s in gcn:
                tickets[s.rid] = self.engine.submit(
                    self._models[s.model].graph, "spmm", b=b[s.rid])
            for s in agnn:
                tickets[s.rid] = self.engine.submit(
                    self._models[s.model].graph, "spmm", b=s.h,
                    edge_vals=att[s.rid])
            out = self._flush_engine(tickets)
        with span("gnn_service.dense"):
            for s in gcn + agnn:
                mdl = self._models[s.model]
                h = out[tickets[s.rid]]
                if isinstance(h, ServeError):
                    s.error = h
                    continue
                if mdl.kind == "agnn":
                    h = h @ mdl.params[layer]["w"]
                if layer < len(mdl.params) - 1:
                    h = torch.relu(h)
                s.h = h

    def _attention(self, agnn: list[_Scoring], layer: int) -> dict:
        """The attention weights of each AGNN scoring at ``layer``: the
        SDDMM of its normalised features (one engine flush), scaled by
        β and passed through the edge softmax. A scoring whose SDDMM
        fails takes the error and no weights."""
        from repro_torch.models.gnn import edge_softmax

        tickets = {}
        for s in agnn:
            hn = s.h / torch.clamp(torch.linalg.vector_norm(
                s.h, dim=-1, keepdim=True), min=1e-9)
            tickets[s.rid] = self.engine.submit(
                self._models[s.model].graph, "sddmm", x=hn, y=hn)
        out = self._flush_engine(tickets)
        att = {}
        for s in agnn:
            mdl = self._models[s.model]
            val = out[tickets[s.rid]]
            if isinstance(val, ServeError):
                s.error = val
                continue
            scores = val * mdl.params[layer]["beta"]
            # duck-typed on (edge_row, m) — the same softmax the
            # training path uses
            att[s.rid] = edge_softmax(mdl, scores)
        return att

    def score(self, model: str, feats, node_ids=None) -> torch.Tensor:
        """Single-request convenience: submit + flush. Raises the typed
        :class:`~repro_torch.serve.resilience.ServeError` if this scoring
        failed (multi-request callers get errors as values instead)."""
        rid = self.submit(model, feats, node_ids)
        out = self.flush()[rid]
        if isinstance(out, ServeError):
            raise out
        return out
