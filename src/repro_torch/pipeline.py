"""The deployment artifact (the serving half of ``repro.pipeline``).

``CompiledLUTNetwork`` owns everything inference needs (tables, mappings,
the two boundary quantizers, the config) and lives on one device, CUDA
unless the caller passes ``device="cpu"``.  ``compile_backend(name)`` plans
a registered lookup backend once and returns a :class:`PlannedExecutor`
(quantize -> cascade -> dequantize); ``save``/``load`` read and write the
reference's ``.npz`` format (``meta_json``, ``table_<l>``, ``mapping_<l>``,
``plan__<backend>__<buf>``, ``extra``), so each package serves the other's
artifacts, persisted fused plans included.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import backends
from repro_torch import device as _device
from repro_torch.core import quant
from repro_torch.core.assemble import AssembleConfig, LayerSpec
from repro_torch.core.folding import FoldedNetwork

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
    network's device.
    """

    def __init__(self, net: "CompiledLUTNetwork",
                 backend: backends.LookupBackend,
                 plan: backends.ExecutionPlan):
        """Bind ``backend`` and its ``plan`` to ``net``'s quantizers."""
        self.backend = backend.name
        self.plan = plan
        self.capabilities = backend.capabilities()
        self.device = net.device
        self._run = backend.run
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
        codes = self._run(self.plan, codes)
        return codes, quant.dequantize_codes(self._out_q, self._out_spec,
                                             codes)

    def predict_codes(self, x) -> torch.Tensor:
        """``[batch, in_features]`` floats -> final-layer codes."""
        codes = quant.quantize_codes(self._in_q, self._in_spec,
                                     self._prepare(x))
        return self._run(self.plan, codes)

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
        self._executors: Dict[str, PlannedExecutor] = {}

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

    def compile_backend(self, name: Optional[str] = None) -> PlannedExecutor:
        """Plan the named backend (default ``self.backend``) once and return
        its executor.  A restored plan of another ``plan_format`` is offered
        to the backend's ``migrate_plan`` first, then re-planned."""
        be = backends.resolve(name or self.backend)
        if be.name not in self._executors:
            plan = self._plans.get(be.name)
            if plan is None or plan.meta.get("plan_format") != be.plan_format:
                migrated = None if plan is None else be.migrate_plan(
                    plan, self.folded())
                plan = self._plans[be.name] = migrated or backends.make_plan(
                    self.folded(), be)
            self._executors[be.name] = PlannedExecutor(self, be, plan)
        return self._executors[be.name]

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
