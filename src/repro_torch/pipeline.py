"""The toolflow and the deployment artifact (``repro.pipeline``).

``Toolflow`` drives the paper's flow on one device (CUDA unless the caller
passes ``device="cpu"``): dense pre-training with the group lasso, pruning
to learned mappings, sparse re-training and exhaustive folding into a
:class:`CompiledLUTNetwork`::

    compiled = Toolflow(cfg).run(data)

``Toolflow`` also takes a stream cell
(:class:`~repro_torch.stream.cell.StreamCellConfig`): it then trains with
truncated BPTT (``tbptt``), and ``compile`` returns a
:class:`~repro_torch.stream.cell.CompiledStreamCell`.

``save_state``/``load_state`` write and read the reference's state file
(``dense_<i>``/``sparse_<i>`` leaves in the reference's leaf order,
``mapping_<l>``, ``manifest_json`` with its ``stream`` entry), so each
package resumes the other's flows, stream flows included.

``CompiledLUTNetwork`` owns everything inference needs (tables, mappings,
the two boundary quantizers, the config) and lives on one device, CUDA
unless the caller passes ``device="cpu"``.  ``compile_backend(name)`` plans
a registered lookup backend once and returns a :class:`PlannedExecutor`
(quantize -> cascade -> dequantize); ``save``/``load`` read and write the
reference's ``.npz`` format (``meta_json``, ``table_<l>``, ``mapping_<l>``,
``plan__<backend>__<buf>``, ``extra``), so each package serves the other's
artifacts, persisted fused plans included.  ``hw_report`` / ``to_verilog``
give the analytic FPGA cost (``core.hwcost``) and the Verilog
(``core.rtl``) of the folded network.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import backends
from repro_torch import device as _device
from repro_torch.core import assemble, folding, hwcost, pruning, quant
from repro_torch.core.assemble import AssembleConfig, LayerSpec, LUTNet
from repro_torch.core.folding import FoldedNetwork
from repro_torch.train import lut_trainer

ARTIFACT_VERSION = 1

default_backend = backends.default_backend


def config_to_dict(cfg: AssembleConfig) -> dict:
    """JSON-ready dict of a config (the artifact's ``config`` entry)."""
    d = dataclasses.asdict(cfg)
    d["layers"] = [dataclasses.asdict(l) for l in cfg.layers]
    return d


def config_from_dict(d: dict) -> AssembleConfig:
    """Inverse of :func:`config_to_dict`."""
    d = dict(d)
    d["layers"] = tuple(LayerSpec(**l) for l in d["layers"])
    return AssembleConfig(**d)


def _tree_to_arrays(prefix: str, net: LUTNet) -> Dict[str, np.ndarray]:
    """``{prefix<i>: leaf}`` in the reference's leaf order."""
    return {f"{prefix}{i}": leaf for i, leaf in enumerate(
        assemble.tree_leaves(assemble.params_to_reference(net)))}


def _tree_from_arrays(prefix: str, like: LUTNet, data, *,
                      device=None) -> LUTNet:
    """A network shaped like ``like`` whose leaves are ``data[prefix<i>]``
    in the reference's leaf order."""
    it = itertools.count()

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(tree[k]) for k in sorted(tree)}
        if isinstance(tree, list):
            return [fill(t) for t in tree]
        return np.asarray(data[f"{prefix}{next(it)}"])

    return assemble.params_from_reference(
        fill(assemble.params_to_reference(like)), device=device)


def _save_npz(path: str, arrays: Dict[str, np.ndarray], meta_key: str,
              meta: dict) -> str:
    """One ``.npz`` with a JSON document embedded under ``meta_key``."""
    arrays = dict(arrays)
    meta = dict(meta, format_version=ARTIFACT_VERSION)
    arrays[meta_key] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez_compressed(path, **arrays)
    return path


def _open_npz(path: str, meta_key: str):
    """Returns (npz handle, decoded meta); the caller closes the handle.
    The handle is closed here on every error path."""
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    data = np.load(path)
    try:
        meta = json.loads(bytes(data[meta_key]).decode("utf-8"))
        if meta.get("format_version", 0) > ARTIFACT_VERSION:
            raise ValueError(
                f"{path}: format {meta.get('format_version')} is newer than "
                f"this code ({ARTIFACT_VERSION})")
    except BaseException:
        data.close()
        raise
    return data, meta


class PlannedExecutor:
    """One lookup backend planned over one compiled network.

    Runs quantize -> ``backend.run`` -> dequantize on the network's device.
    Inputs may be numpy arrays or tensors; outputs are tensors on the
    network's device.  With a :class:`~repro_torch.backends.Placement` the
    cascade runs split over the placement's slots (batch or units); the
    codes equal the unplaced run's and still come back on the network's
    device.
    """

    def __init__(self, net: "CompiledLUTNetwork",
                 backend: backends.LookupBackend,
                 plan: backends.ExecutionPlan,
                 placement: Optional[backends.Placement] = None):
        """Bind ``backend`` and its ``plan`` to ``net``'s quantizers."""
        self.backend = backend.name
        self.plan = plan
        self.placement = placement
        self.capabilities = backend.capabilities()
        self.device = net.device
        if placement is None:
            self._cascade = lambda codes: backend.run(plan, codes)
        else:
            self._cascade = backends.place(backend, plan, placement)
        cfg = net.cfg
        self._in_q = {"log_scale": net.in_log_scale}
        self._out_q = {"log_scale": net.out_log_scale}
        self._in_spec = cfg.input_quant_spec()
        self._out_spec = cfg.quant_spec(len(cfg.layers) - 1)

    def _prepare(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def codes_and_logits(self, x) -> tuple:
        """Final codes ``[B, n_out]`` int32 and logits ``[B, n_out]`` f32."""
        codes = quant.quantize_codes(self._in_q, self._in_spec,
                                     self._prepare(x))
        codes = self._cascade(codes)
        return codes, quant.dequantize_codes(self._out_q, self._out_spec,
                                             codes)

    def predict_codes(self, x) -> torch.Tensor:
        """``[batch, in_features]`` floats -> final-layer codes."""
        codes = quant.quantize_codes(self._in_q, self._in_spec,
                                     self._prepare(x))
        return self._cascade(codes)

    def predict(self, x) -> torch.Tensor:
        """``[batch, in_features]`` floats -> dequantized logits."""
        return self.codes_and_logits(x)[1]

    __call__ = predict


class CompiledLUTNetwork:
    """A folded NeuraLUT-Assemble network, self-contained for deployment.

    Construct with :meth:`load` (an artifact), :meth:`from_numpy` or
    :meth:`from_folded`.  ``device`` defaults to CUDA and raises when no
    card is present; pass ``device="cpu"`` for the plain PyTorch path.
    """

    def __init__(self, cfg: AssembleConfig, tables: List[np.ndarray],
                 mappings: List[Optional[np.ndarray]],
                 in_log_scale: float, out_log_scale: float,
                 *, backend: Optional[str] = None, device=None):
        """Hold the folded parameters (numpy) for planning and saving."""
        self.device = _device.resolve(device)
        self.cfg = cfg
        self.tables = [np.array(t, np.int32) for t in tables]
        self.mappings = [None if m is None else np.array(m, np.int32)
                         for m in mappings]
        self.in_log_scale = float(in_log_scale)
        self.out_log_scale = float(out_log_scale)
        self.backend = backend or default_backend()
        self.extra_meta: Dict[str, Any] = {}
        self._folded: Optional[FoldedNetwork] = None
        self._plans: Dict[str, backends.ExecutionPlan] = {}
        # keyed by (backend name, placement cache_key or None)
        self._executors: Dict[tuple, PlannedExecutor] = {}

    # -- construction --------------------------------------------------------
    @classmethod
    def from_numpy(cls, cfg_dict: dict, tables, mappings, in_log_scale,
                   out_log_scale, *, backend: Optional[str] = None,
                   device=None) -> "CompiledLUTNetwork":
        """The reference constructor's arguments, with the config as the
        JSON dict an artifact embeds (``config_to_dict``)."""
        return cls(config_from_dict(cfg_dict), tables, mappings,
                   in_log_scale, out_log_scale, backend=backend,
                   device=device)

    @classmethod
    def from_folded(cls, net: FoldedNetwork, **kw) -> "CompiledLUTNetwork":
        """Wrap a :class:`FoldedNetwork` (on its own device by default)."""
        if net.mappings is None:
            raise ValueError("FoldedNetwork has no mappings; fold with "
                             "fold_network(params, cfg)")
        kw.setdefault("device", net.device)
        return cls(net.cfg, [t.cpu().numpy() for t in net.tables],
                   [None if m is None else m.cpu().numpy()
                    for m in net.mappings],
                   float(net.in_q["log_scale"]),
                   float(net.out_q["log_scale"]), **kw)

    # -- inference -----------------------------------------------------------
    def folded(self) -> FoldedNetwork:
        """The on-device view (tensors) that backends plan over."""
        if self._folded is None:
            self._folded = FoldedNetwork(
                cfg=self.cfg,
                tables=[torch.from_numpy(t).to(self.device)
                        for t in self.tables],
                in_q={"log_scale": self.in_log_scale},
                out_q={"log_scale": self.out_log_scale},
                mappings=[None if m is None
                          else torch.from_numpy(m).to(self.device)
                          for m in self.mappings])
        return self._folded

    def compile_backend(self, name: Optional[str] = None, *, mesh=None,
                        placement: Optional[backends.Placement] = None,
                        ) -> PlannedExecutor:
        """Plan the named backend (default ``self.backend``) once and return
        its executor.  A restored plan of another ``plan_format`` is offered
        to the backend's ``migrate_plan`` first, then re-planned.

        ``mesh`` (a :class:`~repro_torch.launch.mesh.DeviceMesh`) is sugar
        for ``placement=Placement(mesh)`` (batch-split over the mesh's
        slots).  Planning does not depend on the placement; executors are
        cached per (backend, placement)."""
        if mesh is not None:
            if placement is not None:
                raise ValueError("pass either mesh= or placement=, not both")
            placement = backends.Placement(mesh)
        be = backends.resolve(name or self.backend)
        key = (be.name, None if placement is None else placement.cache_key())
        if key not in self._executors:
            plan = self._plans.get(be.name)
            if plan is None or plan.meta.get("plan_format") != be.plan_format:
                migrated = None if plan is None else be.migrate_plan(
                    plan, self.folded())
                plan = self._plans[be.name] = migrated or backends.make_plan(
                    self.folded(), be)
            self._executors[key] = PlannedExecutor(self, be, plan,
                                                   placement=placement)
        return self._executors[key]

    def predict_codes(self, x, *, backend: Optional[str] = None
                      ) -> torch.Tensor:
        """``[batch, in_features]`` floats -> final-layer integer codes."""
        return self.compile_backend(backend).predict_codes(x)

    def predict(self, x, *, backend: Optional[str] = None) -> torch.Tensor:
        """``[batch, in_features]`` floats -> dequantized logits."""
        return self.compile_backend(backend).predict(x)

    def codes_and_logits(self, x, *, backend: Optional[str] = None) -> tuple:
        """Both outputs of one cascade pass."""
        return self.compile_backend(backend).codes_and_logits(x)

    def num_entries(self) -> int:
        """Total table entries over all layers."""
        return int(sum(t.shape[0] * t.shape[1] for t in self.tables))

    # -- hardware ------------------------------------------------------------
    def hw_report(self, pipeline_every: int = 3) -> hwcost.HwReport:
        """Analytic LUT count, Fmax, latency and area-delay product."""
        return hwcost.report(self.cfg, pipeline_every=pipeline_every)

    def to_verilog(self, **kw) -> str:
        """One synthesizable Verilog module of the folded network
        (``rtl.emit_verilog`` keywords)."""
        from repro_torch.core import rtl
        return rtl.emit_verilog(self.folded(), **kw)

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> str:
        """Write one ``.npz`` in the reference's format; plans computed so
        far ride along unless their backend re-derives them trivially."""
        arrays: Dict[str, np.ndarray] = {}
        for l, t in enumerate(self.tables):
            arrays[f"table_{l}"] = t
        for l, m in enumerate(self.mappings):
            if m is not None:
                arrays[f"mapping_{l}"] = m
        plans_meta: Dict[str, Any] = {}
        for name, plan in self._plans.items():
            try:
                persist = backends.get(name).persist_plan
            except ValueError:
                persist = True
            if not persist:
                continue
            plans_meta[name] = plan.meta
            for k, buf in plan.buffers.items():
                arrays[f"plan__{name}__{k}"] = buf
        meta = {
            "config": config_to_dict(self.cfg),
            "in_log_scale": self.in_log_scale,
            "out_log_scale": self.out_log_scale,
            "backend": self.backend,
            "plans": plans_meta,
            "extra": self.extra_meta,
        }
        return _save_npz(path, arrays, "meta_json", meta)

    @classmethod
    def load(cls, path: str, *, device=None) -> "CompiledLUTNetwork":
        """Read an artifact written by either package onto ``device``
        (CUDA by default): the folded parameters become the port's tensors
        and persisted plans are restored as they were saved."""
        dev = _device.resolve(device)
        data, meta = _open_npz(path, "meta_json")
        with data:
            cfg = config_from_dict(meta["config"])
            tables = [data[f"table_{l}"] for l in range(len(cfg.layers))]
            mappings = [data[f"mapping_{l}"] if f"mapping_{l}" in data
                        else None for l in range(len(cfg.layers))]
            net = cls(cfg, tables, mappings, meta["in_log_scale"],
                      meta["out_log_scale"], backend=meta.get("backend"),
                      device=dev)
            net.extra_meta = meta.get("extra") or {}
            for name, pmeta in meta.get("plans", {}).items():
                prefix = f"plan__{name}__"
                bufs = {k[len(prefix):]: data[k]
                        for k in data.files if k.startswith(prefix)}
                net._plans[name] = backends.ExecutionPlan(
                    backend=name, meta=pmeta, buffers=bufs)
        return net


def compile_network(params: LUTNet, cfg: AssembleConfig, *,
                    backend: Optional[str] = None) -> CompiledLUTNetwork:
    """Fold trained ``params`` (on their own device) into a deployment
    artifact on that device."""
    return CompiledLUTNetwork.from_folded(folding.fold_network(params, cfg),
                                          backend=backend)


@dataclasses.dataclass
class StageResult:
    """What one toolflow stage did: its name, wall seconds and metrics."""

    name: str
    seconds: float
    metrics: Dict[str, Any]


class Toolflow:
    """The paper's three training phases plus compilation, in order.

    Stages run in order (``pretrain`` -> ``prune`` -> ``retrain`` ->
    ``compile``), each returning ``self`` (``compile`` returns the
    artifact).  ``retrain`` without ``prune`` uses random mappings.
    ``stages`` records what ran.  Every stage runs on ``device`` (CUDA by
    default).  A :class:`~repro_torch.stream.cell.StreamCellConfig` routes
    the flow through the sequential paths: truncated BPTT over ``tbptt``
    steps, last-step accuracy and ``compile`` -> ``CompiledStreamCell``.
    :meth:`search` runs the hardware-aware assembly search of a registered
    task.
    """

    def __init__(self, cfg, *, pretrain_steps: int = 120,
                 retrain_steps: int = 250, lr: float = 5e-3,
                 pretrain_lr: Optional[float] = None,
                 batch_size: int = 256, lasso: float = 1e-4,
                 weight_decay: float = 1e-4, sgdr_t0: int = 100,
                 seed: int = 0, max_train: int = 4096, tbptt: int = 8,
                 rolled_training: bool = False, device=None):
        """Hold the config and hyperparameters; nothing runs yet.
        ``rolled_training`` trains each phase as the reference's one-program
        loop (``lut_trainer.train(rolled=True)``: the loss history keeps
        the final step's); the search promotes survivors this way."""
        # duck-typed, so this module never imports repro_torch.stream at
        # import time (stream.cell imports this module)
        if hasattr(cfg, "net") and hasattr(cfg, "n_state"):
            self.cell = cfg
            cfg = cfg.net
        else:
            self.cell = None
        self.cfg = cfg
        self.tbptt = tbptt
        self.rolled_training = rolled_training and self.cell is None
        self.device = _device.resolve(device)
        self.hyper = dict(pretrain_steps=pretrain_steps,
                          retrain_steps=retrain_steps, lr=lr,
                          pretrain_lr=pretrain_lr, batch_size=batch_size,
                          lasso=lasso, weight_decay=weight_decay,
                          sgdr_t0=sgdr_t0, seed=seed, max_train=max_train)
        self.data = None
        self.dense_params: Optional[LUTNet] = None
        self.mappings: Optional[List[Optional[torch.Tensor]]] = None
        self.params: Optional[LUTNet] = None          # sparse (deployable)
        self.compiled: Optional[CompiledLUTNetwork] = None
        self.stages: Dict[str, StageResult] = {}

    def _record(self, name: str, t0: float, **metrics) -> None:
        self.stages[name] = StageResult(name=name,
                                        seconds=time.time() - t0,
                                        metrics=metrics)

    def _require(self, attr: str, stage: str, needed_by: str) -> Any:
        val = getattr(self, attr)
        if val is None:
            raise RuntimeError(
                f"Toolflow.{needed_by}() needs {attr!r}: run .{stage}() "
                "first (or load_state a saved flow)")
        return val

    def pretrain(self, data) -> "Toolflow":
        """Phase 1: dense pre-training with the group-lasso regularizer
        (mapping layers read the whole previous layer)."""
        h = self.hyper
        t0 = time.time()
        kw = dict(dense=True, lasso=h["lasso"], steps=h["pretrain_steps"],
                  lr=h["pretrain_lr"] if h["pretrain_lr"] is not None
                  else h["lr"],
                  batch_size=h["batch_size"], weight_decay=h["weight_decay"],
                  seed=h["seed"], max_train=h["max_train"],
                  device=self.device)
        if self.cell is not None:
            res = lut_trainer.train_stream(self.cell, data, tbptt=self.tbptt,
                                           **kw)
        else:
            res = lut_trainer.train(self.cfg, data,
                                    rolled=self.rolled_training, **kw)
        self.data = data
        self.dense_params = res.params
        self._record("pretrain", t0, final_loss=res.losses[-1],
                     steps=h["pretrain_steps"])
        return self

    def prune(self) -> "Toolflow":
        """Phase 2: keep the top-F inputs per unit by group norm; these are
        the learned mappings."""
        dense = self._require("dense_params", "pretrain", "prune")
        t0 = time.time()
        self.mappings = pruning.select_mappings(dense, self.cfg)
        self._record("prune", t0, coverage=pruning.mapping_coverage(
            self.mappings, self.cfg))
        return self

    def retrain(self, data=None) -> "Toolflow":
        """Phase 3: sparse re-training from scratch with the learned
        mappings (random mappings if ``prune`` was skipped)."""
        data = data if data is not None else self._require(
            "data", "pretrain", "retrain")
        h = self.hyper
        t0 = time.time()
        kw = dict(mappings=self.mappings, steps=h["retrain_steps"],
                  lr=h["lr"], batch_size=h["batch_size"],
                  weight_decay=h["weight_decay"], sgdr_t0=h["sgdr_t0"],
                  seed=h["seed"], max_train=h["max_train"],
                  device=self.device)
        if self.cell is not None:
            res = lut_trainer.train_stream(self.cell, data, tbptt=self.tbptt,
                                           **kw)
        else:
            res = lut_trainer.train(self.cfg, data,
                                    rolled=self.rolled_training, **kw)
        self.data = data
        self.params = res.params
        self._record("retrain", t0, final_loss=res.losses[-1],
                     steps=h["retrain_steps"],
                     learned_mappings=self.mappings is not None)
        return self

    def compile(self, *, backend: Optional[str] = None):
        """Phase 4: exhaustive fold into the deployment artifact, a
        :class:`CompiledLUTNetwork` or, for stream flows, a
        :class:`~repro_torch.stream.cell.CompiledStreamCell`."""
        params = self._require("params", "retrain", "compile")
        t0 = time.time()
        if self.cell is not None:
            from repro_torch.stream import cell as stream_cell
            self.compiled = stream_cell.compile_cell(params, self.cell,
                                                     backend=backend)
            entries = self.compiled.net.num_entries()
        else:
            self.compiled = compile_network(params, self.cfg,
                                            backend=backend)
            entries = self.compiled.num_entries()
        self._record("compile", t0, entries=entries)
        return self.compiled

    def run(self, data) -> CompiledLUTNetwork:
        """All four phases end to end."""
        return self.pretrain(data).prune().retrain().compile()

    @classmethod
    def search(cls, task: str, budget=None, *, data=None, mesh=None,
               device=None):
        """Search the assembly space of a registered task
        (``configs.paper_tasks.TASKS``).

        Explores fan-in / unit-width / depth / beta / skip-placement
        variants of the task's base design with stacked short-horizon
        training (K4 on the card) and successive halving, then fully trains
        the Pareto survivors through this driver.  Returns a
        :class:`repro_torch.search.SearchResult` whose ``frontier`` is the
        ranked accuracy / area-delay-product Pareto frontier; every point
        carries a deployable :class:`CompiledLUTNetwork`
        (``point.compiled``).

        ``budget`` is a :class:`repro_torch.search.SearchBudget` (the
        standard budget by default; ``SearchBudget.smoke()`` for CI-sized
        runs).  Everything runs on ``device``, CUDA by default (``"cpu"``
        for the plain path).  ``mesh`` (``launch.mesh.make_serving_mesh``)
        runs the population slices on its slots with straggler-aware rung
        promotion and elastic remesh; the slots' devices are used then.
        """
        from repro_torch.search import run_search
        return run_search(task, budget=budget, data=data, mesh=mesh,
                          device=device)

    def accuracy(self, data=None, *, folded: bool = False,
                 max_eval: int = 2048) -> float:
        """Test accuracy of the sparse model (or its folded tables)."""
        data = data if data is not None else self._require(
            "data", "pretrain", "accuracy")
        params = self._require("params", "retrain", "accuracy")
        if self.cell is not None:
            return lut_trainer.stream_accuracy(self.cell, params, data,
                                               folded=folded,
                                               max_eval=max_eval)
        return lut_trainer.accuracy(self.cfg, params, data, folded=folded,
                                    max_eval=max_eval)

    def save_state(self, path: str) -> str:
        """Persist the finished stages' outputs to one ``.npz`` in the
        reference's layout; ``data`` is not saved."""
        arrays: Dict[str, np.ndarray] = {}
        done = []
        if self.dense_params is not None:
            arrays.update(_tree_to_arrays("dense_", self.dense_params))
            done.append("pretrain")
        if self.mappings is not None:
            for l, m in enumerate(self.mappings):
                if m is not None:
                    arrays[f"mapping_{l}"] = m.cpu().numpy()
            done.append("prune")
        if self.params is not None:
            arrays.update(_tree_to_arrays("sparse_", self.params))
            done.append("retrain")
        manifest = {"config": config_to_dict(self.cfg), "hyper": self.hyper,
                    "done": done,
                    "stream": None if self.cell is None else {
                        "n_in": self.cell.n_in,
                        "n_state": self.cell.n_state,
                        "tbptt": self.tbptt}}
        return _save_npz(path, arrays, "manifest_json", manifest)

    @classmethod
    def load_state(cls, path: str, *, device=None) -> "Toolflow":
        """Resume a flow saved by either package onto ``device`` (CUDA by
        default)."""
        data, manifest = _open_npz(path, "manifest_json")
        with data:
            cfg = config_from_dict(manifest["config"])
            stream = manifest.get("stream")
            if stream:
                from repro_torch.stream.cell import StreamCellConfig
                flow = cls(StreamCellConfig(net=cfg, n_in=stream["n_in"],
                                            n_state=stream["n_state"]),
                           tbptt=stream["tbptt"], device=device,
                           **manifest["hyper"])
            else:
                flow = cls(cfg, device=device, **manifest["hyper"])
            seed = flow.hyper["seed"]
            if "prune" in manifest["done"]:
                flow.mappings = [
                    None if spec.assemble else torch.from_numpy(
                        np.array(data[f"mapping_{l}"], np.int32)
                    ).to(flow.device)
                    for l, spec in enumerate(cfg.layers)]
            if "pretrain" in manifest["done"]:
                like = assemble.init(seed, cfg, dense=True, device="cpu")
                flow.dense_params = _tree_from_arrays(
                    "dense_", like, data, device=flow.device)
            if "retrain" in manifest["done"]:
                like = assemble.init(seed, cfg, mappings=flow.mappings,
                                     device="cpu")
                flow.params = _tree_from_arrays("sparse_", like, data,
                                                device=flow.device)
        return flow
