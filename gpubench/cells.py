"""One cell of the benchmark: its configuration, its traffic, the
program under test, the measured window and the comparison.

Everything a cell needs is found by name: the cell's entry in
``BENCHMARK.json`` names a configuration (``gpubench/configs/<name>.json``)
and a traffic mix (``gpubench/traffic/<name>.json``), and its
comparison's limits sit in ``gpubench/limits/<cell>.json``. The traffic
file's ``kind`` picks one of the two drivers below: ``train`` (a closed
loop of full-batch steps) or ``serve`` (an open loop of scoring
requests). The configuration's ``model`` names its kind's module,
``gpubench/models/<model>.py`` (:func:`model_kind`; see
:mod:`gpubench.models` for what it gives), and through it the kind's
plain reference (:func:`reference`). The program is ``repro_torch``;
this module imports it only inside the functions that build it.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import pathlib
import sys
import time
import traceback

import torch

from gpubench import check, graphs, traffic

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "gpubench"

#: Seconds at the end of a traced window that run under the profiler.
SLICE_S = 2.0


def load(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, spec: dict | None = None) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic) of the cell ``name``."""
    spec = bench() if spec is None else spec
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return entry, load("configs", entry["config"]), \
        load("traffic", entry["traffic"])


def limits(name: str) -> dict:
    path = HERE / "limits" / f"{name}.json"
    return json.loads(path.read_text())["limits"] if path.exists() else {}


def load_module(folder: str, name: str):
    """``gpubench/<folder>/<name>.py``, loaded by path: what the
    benchmark finds by a name in its data (a per-layer metric's reader,
    a model kind, a kind's reference), so that a later one is a new
    file and no edit."""
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gpubench.{folder}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def model_kind(cfg: dict):
    """The module of the configuration's model kind."""
    return load_module("models", cfg["model"])


def reference(cfg: dict):
    """The plain reference of the configuration's model kind."""
    return load_module("reference", model_kind(cfg).REFERENCE)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Spans:
    """Host-clock spans the harness records around calls into the
    program, by name, in seconds."""

    def __init__(self):
        self.spans: dict[str, list[float]] = {}

    def add(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)


# --------------------------------------------------------------- the world
class World:
    """What a configuration builds once, whatever the seed: the graph
    (the benchmark's arrays, handed to the program as its ``SparseCSR``)
    and the program's plans (train: ``gops`` and what else the model
    kind's ``build_train`` sets) or serving tier (serve)."""

    def __init__(self, cfg: dict, kind: str, dev: torch.device,
                 spans: Spans, tune_cache: str | None = None):
        from repro_torch.sparse.matrix import SparseCSR

        self.cfg, self.kind, self.dev = cfg, kind, dev
        t = time.perf_counter()
        self.graph = graphs.from_recipe(cfg["graph"])
        spans.add("graph", time.perf_counter() - t)
        g = self.graph
        self.csr = SparseCSR(g.m, g.k, g.indptr, g.indices, g.data)
        cache = str(ROOT / cfg["tune_cache"]) if tune_cache is None \
            else tune_cache
        if kind == "train":
            from repro_torch.api import ExecSpec

            spec = ExecSpec(**cfg["exec_spec"], tune_cache=cache,
                            device=str(dev))
            t = time.perf_counter()
            model_kind(cfg).build_train(self, spec)
            sync(dev)
            spans.add("plan_build", time.perf_counter() - t)
        else:
            from repro_torch.serve import GNNService, GraphRegistry, \
                SparseEngine

            reg = GraphRegistry(**cfg["registry"], device=str(dev),
                                tune_cache=cache)
            self.service = GNNService(SparseEngine(reg))
        self.spans = spans


def draw_weights(dims: list[int], seed: int,
                 dev: torch.device) -> list[torch.Tensor]:
    """A weight a layer from ``seed``, drawn on the device in one call:
    ``randn(d_in, d_out) / sqrt(d_in)`` for each pair of ``dims``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    sizes = [a * b for a, b in zip(dims[:-1], dims[1:])]
    flat = torch.randn(sum(sizes), generator=gen, device=dev)
    out, off = [], 0
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        w = flat[off:off + d_in * d_out].view(d_in, d_out) / math.sqrt(d_in)
        off += d_in * d_out
        out.append(w.contiguous())
    return out


def draw_params(cfg: dict, seed: int, dev: torch.device) -> list[dict]:
    """The model's layers from ``seed``, as its kind draws them."""
    return model_kind(cfg).draw_params(cfg, seed, dev)


def draw_inputs(world: World, seed: int):
    """A training cell's features and labels from ``seed``, on the device."""
    cfg, dev, n = world.cfg, world.dev, world.graph.m
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn(n, cfg["dims"][0], generator=gen, device=dev)
    labels = torch.randint(0, cfg["dims"][-1], (n,), generator=gen,
                           device=dev)
    return x, labels


def draw_pool(world: World, seed: int, panels: int) -> torch.Tensor:
    """A serving cell's pool of feature panels from ``seed``."""
    gen = torch.Generator(device=world.dev).manual_seed(seed + 1)
    return torch.randn(panels, world.graph.m, world.cfg["dims"][0],
                       generator=gen, device=world.dev)


def module(cfg: dict, layers: list[dict], dev: torch.device):
    """The program's model of the configuration's kind, holding
    ``layers``."""
    return model_kind(cfg).module(cfg, layers, dev)


def snapshot(layers_or_leaves) -> list[torch.Tensor]:
    return [p.detach().clone().float() for p in layers_or_leaves]


# ------------------------------------------------------------ training
class TrainProgram:
    """The program's full-batch training step on the world's plans."""

    def __init__(self, world: World, seed: int):
        from repro_torch.models.gnn import train_step

        cfg, dev = world.cfg, world.dev
        self.world, self.cfg = world, cfg
        self._kind = model_kind(cfg)
        self.layers0 = self._kind.draw_params(cfg, seed, dev)
        self.x, self.labels = draw_inputs(world, seed)
        self.model = self._kind.module(cfg, self.layers0, dev)
        self._args = self._kind.train_args(world)
        self._train_step = train_step

    def step(self) -> torch.Tensor:
        return self._train_step(self.model, self.world.gops, self.x,
                                self.labels, *self._args,
                                lr=self.cfg["optimizer"]["lr"])

    def leaves(self) -> list[torch.Tensor]:
        return self._kind.leaves(self.model)

    def free(self) -> None:
        del self.model


class ReferenceTrainProgram(TrainProgram):
    """The reference in the program's place: the control (a lower
    ``dtype``) and the planted faults (``loss_rows``: half the batch)."""

    def __init__(self, world: World, seed: int, *, dtype=torch.float32,
                 loss_rows=None):
        from gpubench.reference import gnn as ref

        self.world, self.cfg = world, world.cfg
        self.layers0 = draw_params(world.cfg, seed, world.dev)
        self.x, self.labels = draw_inputs(world, seed)
        self._ref, self._dtype, self._rows = ref, dtype, loss_rows
        self._model = reference(world.cfg)
        self._edges = check.edges(world.graph, world.dev)
        self._layers = [{k: v.clone() for k, v in layer.items()}
                        for layer in self.layers0]

    def step(self) -> torch.Tensor:
        losses, states = self._ref.train(
            self._model, self._layers, self._edges, self.x,
            self.labels, lr=self.cfg["optimizer"]["lr"], steps=1,
            dtype=self._dtype, loss_rows=self._rows)
        it = iter(states[0])
        for layer in self._layers:
            for k in self._model.KEYS:
                if k in layer:
                    layer[k] = next(it)
        return torch.tensor(losses[0])

    def leaves(self) -> list[torch.Tensor]:
        return self._ref.leaves(self._layers, self._model.KEYS)

    def free(self) -> None:
        del self._layers, self._edges


def train_check_steps(prog, steps: int) -> dict:
    """Drive the step's first ``steps`` calls and keep what the
    comparison needs: the parameters before, after the first step and
    after the last, and each step's loss."""
    theta0 = snapshot(prog.leaves())
    losses, theta1 = [], None
    for s in range(steps):
        losses.append(prog.step())
        if s == 0:
            theta1 = snapshot(prog.leaves())
    return {"theta0": theta0, "theta1": theta1,
            "theta_k": snapshot(prog.leaves()),
            "losses": [float(v) for v in losses]}


def train_window(prog, dev, seconds: float, slicer=None) -> dict:
    """Back-to-back steps for ``seconds``, with no synchronisation
    between them; the window ends with one after the last step started.
    With ``slicer``, the steps of the last :data:`SLICE_S` seconds run
    under the profiler (the window stretches so the slice keeps its
    length), and the steps before it are timed apart (``pre``)."""
    sync(dev)
    t0 = time.perf_counter()
    end = t0 + seconds
    cut = end - SLICE_S if slicer is not None else math.inf
    steps, pre, loss = 0, None, None
    while time.perf_counter() < end:
        if pre is None and time.perf_counter() >= cut:
            sync(dev)
            pre = (time.perf_counter() - t0, steps)
            slicer.start()
            end = max(end, time.perf_counter() + SLICE_S)
        loss = prog.step()
        steps += 1
    sync(dev)
    total = time.perf_counter() - t0
    if pre is not None:
        slicer.stop()
    return {"steps": steps, "seconds": total, "pre": pre,
            "finite": loss is None or bool(torch.isfinite(loss).all())}


# ------------------------------------------------------------- serving
class ServeProgram:
    """The program's scoring service with one model registered."""

    def __init__(self, world: World, seed: int, pool_panels: int):
        cfg, dev = world.cfg, world.dev
        self.world = world
        kind = model_kind(cfg)
        layers = kind.draw_params(cfg, seed, dev)
        self.layers0 = layers
        model = kind.module(cfg, layers, dev)
        self.name = f"{cfg['model']}-{seed}"
        t = time.perf_counter()
        kind.register(world.service, self.name, world.csr, model)
        sync(dev)
        world.spans.add("plan_build", time.perf_counter() - t)
        self.pool = draw_pool(world, seed, pool_panels)

    def submit(self, panel: int, node_ids) -> int:
        return self.world.service.submit(self.name, self.pool[panel],
                                         node_ids)

    def flush(self) -> dict:
        return self.world.service.flush()

    def recover(self) -> None:
        """Drop what a refused flush left in the engine's queue."""
        self.world.service.engine.flush()

    def free(self) -> None:
        del self.pool


class ReferenceServeProgram(ServeProgram):
    """The reference in the serving tier's place (the control)."""

    def __init__(self, world: World, seed: int, pool_panels: int, *,
                 dtype=torch.bfloat16):
        self.world = world
        self.layers0 = draw_params(world.cfg, seed, world.dev)
        self.pool = draw_pool(world, seed, pool_panels)
        self._model, self._dtype = reference(world.cfg), dtype
        self._edges = check.edges(world.graph, world.dev)
        self._queue: list = []
        self._rid = 0

    def submit(self, panel: int, node_ids) -> int:
        self._queue.append((self._rid, panel, node_ids))
        self._rid += 1
        return self._rid - 1

    def flush(self) -> dict:
        out = {}
        for rid, panel, ids in self._queue:
            with torch.no_grad():
                h = self._model.forward(self.layers0, self._edges,
                                        self.pool[panel],
                                        self._dtype).float()
            out[rid] = h if ids is None else h[ids]
        self._queue = []
        return out

    def recover(self) -> None:
        self._queue = []


def warm_serve(prog, dev, plan: traffic.Schedule, max_batch: int) -> None:
    """Flushes of 1, 2, 4 and 8 requests (every panel bucket the engine
    packs a batch into) and of ``max_batch`` (the largest batch the loop
    hands a flush, so the caching allocator holds its memory before the
    window: a first ``cudaMalloc`` of a larger batch stalls the loop),
    twice, with the mix's subset requests among them."""
    for _ in range(2):
        for size in sorted({1, 2, 4, 8, max_batch}):
            for j in range(size):
                prog.submit(plan.panels[j % len(plan.panels)],
                            plan.subset_ids(j) if j % 3 == 2 else None)
            prog.flush()
            sync(dev)


def serve_window(prog, dev, plan: traffic.Schedule, spans: Spans,
                 slicer=None, *, max_batch: int) -> dict:
    """The open loop: the requests due (``max_batch`` at most) are
    submitted, then one flush serves them and ends in a synchronisation.
    A request is timed from its due time to that synchronisation. With
    ``slicer``, the arrivals of the last :data:`SLICE_S` seconds and the
    drain after them run under the profiler."""
    from torch.profiler import record_function

    n = len(plan.due)
    lat = [math.inf] * n
    late = []
    kept, errors = {}, 0
    sync(dev)
    t0 = time.perf_counter()
    cut = plan.seconds - SLICE_S if slicer is not None else math.inf
    sliced = False
    i = 0
    while i < n:
        now = time.perf_counter() - t0
        if not sliced and now >= cut:
            slicer.start()
            sliced = True
            now = time.perf_counter() - t0
        pending = []
        while i < n and plan.due[i] <= now and len(pending) < max_batch:
            late.append(now - plan.due[i])
            rid = prog.submit(plan.panels[i],
                              plan.subset_ids(i) if plan.subset[i] else None)
            pending.append((i, rid))
            i += 1
        if pending:
            tf = time.perf_counter()
            with record_function("gpubench.flush"):
                try:
                    out = prog.flush()
                except Exception:   # the whole flush is refused: count it
                    traceback.print_exc(file=sys.stderr)
                    prog.recover()
                    out = {}
                sync(dev)
            done = time.perf_counter()
            spans.add("flush", done - tf)
            spans.add("batch", float(len(pending)))
            for j, rid in pending:
                res = out.get(rid)
                if res is None or isinstance(res, Exception):
                    errors += 1
                    continue
                lat[j] = done - t0 - plan.due[j]
                if j in plan.check:
                    kept[j] = res
            continue
        if i < n:
            wait = plan.due[i] - (time.perf_counter() - t0)
            if wait > 1e-3:
                with record_function("gpubench.wait_for_arrival"):
                    time.sleep(wait - 5e-4)
    if sliced:
        slicer.stop()
    return {"latency_s": lat, "late_s": late, "kept": kept, "errors": errors,
            "seconds": time.perf_counter() - t0}


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile ``q`` (0-100) of ``values``."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


# --------------------------------------------------------------- freeing
def release(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

