"""Training of NeuraLUT-Assemble models (``repro.train.lut_trainer``).

The paper's three phases as library calls: :func:`train` with
``dense=True, lasso>0`` (dense pre-training with the hardware-aware group
regularizer), ``pruning.select_mappings`` (structured pruning to fan-in F),
then :func:`train` with ``mappings=...`` (sparse re-training from scratch).
``repro_torch.pipeline.Toolflow`` drives them end to end.

AdamW + SGDR from :mod:`repro_torch.train.optim`.  Every affine of the
forward, and the ``dx`` of its backward, runs through kernel K4 on the
card.  The loop keeps each step's loss on the device and reads them all
once at the end, so the host never waits on the card inside the loop.
:func:`train_stream` trains recurrent stream cells with truncated BPTT.
Population training (:func:`train_population`, the assembly search's
scorer) trains a group of same-shape candidates as one stacked network.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import assemble, folding, quant, subnet
from repro_torch.core.assemble import AssembleConfig, LUTNet
from repro_torch.data.synthetic import Dataset
from repro_torch.train import losses, optim


@dataclasses.dataclass
class TrainResult:
    """Trained parameters and the loss of every step."""

    params: LUTNet
    losses: List[float]


def loss_fn(net: LUTNet, cfg: AssembleConfig, xb: torch.Tensor,
            yb: torch.Tensor, *, dense: bool = False,
            lasso: float = 0.0) -> torch.Tensor:
    """Training loss of one batch (BN statistics in ``net`` refreshed):
    cross-entropy (binary for a single output) plus the group lasso."""
    logits = assemble.apply(net, cfg, xb, training=True, dense=dense)
    if cfg.layers[-1].units == 1:
        loss = losses.binary_cross_entropy(logits, yb)
    else:
        loss = losses.softmax_cross_entropy(logits, yb)
    if lasso:
        loss = loss + lasso * assemble.group_lasso(net, cfg)
    return loss


def train_step(net: LUTNet, cfg: AssembleConfig, ocfg: optim.AdamWConfig,
               opt: optim.AdamWState, xb: torch.Tensor, yb: torch.Tensor, *,
               dense: bool = False, lasso: float = 0.0):
    """One step: forward (refreshing BN statistics), backward, AdamW over
    every leaf in the reference's order.  Returns (new optimizer state,
    loss tensor); ``net`` is updated in place."""
    for p in net.parameters():
        p.grad = None
    loss = loss_fn(net, cfg, xb, yb, dense=dense, lasso=lasso)
    loss.backward()
    params = assemble.leaves(net)
    grads = [p.grad if isinstance(p, torch.nn.Parameter) else None
             for p in params]
    opt, _ = optim.adamw_update(ocfg, params, grads, opt)
    return opt, loss.detach()


def train(cfg: AssembleConfig, data: Dataset, *, steps: int = 200,
          lr: float = 5e-3, batch_size: int = 256, dense: bool = False,
          mappings: Optional[Sequence] = None, lasso: float = 0.0,
          weight_decay: float = 1e-4, sgdr_t0: int = 0, seed: int = 0,
          max_train: int = 4096, rolled: bool = False,
          device=None) -> TrainResult:
    """Train one model from a fresh init (seeded by ``seed``) on
    ``device`` (CUDA by default); batches walk the first ``max_train``
    training rows in order, as in the reference.

    ``rolled=True`` is the reference's one-program loop: the same steps on
    device-side batch slices, and only the final step's loss is kept (the
    history has one entry).  Neither loop waits on the card inside it, so
    both give the same parameters."""
    dev = _device.resolve(device)
    net = assemble.init(seed, cfg, dense=dense, mappings=mappings, device=dev)
    ocfg = optim.AdamWConfig(
        lr=lr, weight_decay=weight_decay,
        schedule=optim.sgdr_schedule(sgdr_t0) if sgdr_t0 else None)
    opt = optim.adamw_init(assemble.leaves(net))
    x = torch.from_numpy(np.asarray(data.x_train[:max_train])).to(dev)
    y = torch.from_numpy(np.asarray(data.y_train[:max_train])).to(dev)
    n = x.shape[0]
    bs = min(batch_size, n)
    hist = []
    for i in range(steps):
        lo = (i * bs) % (n - bs + 1)
        opt, loss = train_step(net, cfg, ocfg, opt, x[lo:lo + bs],
                               y[lo:lo + bs], dense=dense, lasso=lasso)
        hist.append(loss)
    if rolled:
        hist = hist[-1:] or [torch.zeros((), device=dev)]
    return TrainResult(params=net,
                       losses=torch.stack(hist).tolist() if hist else [])


# ---------------------------------------------------------------------------
# Sequential tasks: truncated BPTT over repro_torch.stream cells
# ---------------------------------------------------------------------------

def train_stream_step(net: LUTNet, cell, ocfg: optim.AdamWConfig,
                      opt: optim.AdamWState, xb: torch.Tensor,
                      yb: torch.Tensor, *, window: int, dense: bool = False,
                      lasso: float = 0.0, batch_stats: bool = True):
    """One truncated-BPTT step on sequences ``xb [B, T, n_in]``: the state
    is detached every ``window`` steps, the classification loss is read at
    the last step of every window and averaged (plus the group lasso),
    then backward and AdamW.  Returns (new optimizer state, loss tensor);
    ``net`` is updated in place, its BN statistics refreshed at every step
    (``batch_stats=False`` normalizes with the running statistics).

    With frozen statistics (``batch_stats=False``) the loss depends on the
    BN running statistics the step started from, through every step's EMA,
    so they get a gradient, as the reference's carried parameters do: they
    are made leaves of the graph for the step, and AdamW moves the
    refreshed statistics by it."""
    from repro_torch.stream import cell as cell_mod
    for p in net.parameters():
        p.grad = None
    if not batch_stats:
        for layer in net.layers:
            bn = layer.subnet.bn
            bn.mean = bn.mean.detach().requires_grad_(True)
            bn.var = bn.var.detach().requires_grad_(True)
    start = assemble.leaves(net)
    s = torch.zeros((xb.shape[0], cell.n_state), dtype=xb.dtype,
                    device=xb.device)
    starts = range(0, xb.shape[1], window)
    total = 0.0
    for lo in starts:
        ys, s = cell_mod.apply_sequence(net, cell, xb[:, lo:lo + window], s,
                                        training=True, dense=dense,
                                        bn_batch_stats=batch_stats)
        logits = ys[:, -1]
        total = total + (losses.binary_cross_entropy(logits, yb)
                         if cell.n_out == 1 else
                         losses.softmax_cross_entropy(logits, yb))
        s = s.detach()
    loss = total / len(starts)
    if lasso:
        loss = loss + lasso * assemble.group_lasso(net, cell.net)
    loss.backward()
    for layer in net.layers:
        bn = layer.subnet.bn
        bn.mean, bn.var = bn.mean.detach(), bn.var.detach()
    grads = [p.grad if p.requires_grad else None for p in start]
    opt, _ = optim.adamw_update(ocfg, assemble.leaves(net), grads, opt)
    return opt, loss.detach()


def train_stream(cell, data, *, steps: int = 200, lr: float = 5e-3,
                 batch_size: int = 64, dense: bool = False,
                 mappings: Optional[Sequence] = None, lasso: float = 0.0,
                 weight_decay: float = 1e-4, sgdr_t0: int = 0, seed: int = 0,
                 max_train: int = 2048, tbptt: int = 0,
                 bn_freeze_frac: float = 0.25, device=None) -> TrainResult:
    """Train a :class:`~repro_torch.stream.cell.StreamCellConfig` on
    ``[N, T, n_in]`` sequences (``data.synthetic.SeqDataset``) labelled per
    sequence, on ``device`` (CUDA by default).

    The loop carries the *fake-quantized* state values between steps, the
    training-graph image of the folded cell's code-space recurrence.  With
    ``tbptt=k > 0`` the gradient is cut every ``k`` steps and the loss read
    at the last step of every window (averaged); ``tbptt=0`` backprops
    through the whole sequence with the loss at the final step only.  The
    last ``bn_freeze_frac`` of the steps train with frozen-stats BN, the
    normalization the folded cell deploys.
    """
    from repro_torch.stream import cell as cell_mod
    dev = _device.resolve(device)
    net = cell_mod.init(seed, cell, dense=dense, mappings=mappings,
                        device=dev)
    ocfg = optim.AdamWConfig(
        lr=lr, weight_decay=weight_decay,
        schedule=optim.sgdr_schedule(sgdr_t0) if sgdr_t0 else None)
    opt = optim.adamw_init(assemble.leaves(net))
    x = torch.from_numpy(np.asarray(data.x_train[:max_train])).to(dev)
    y = torch.from_numpy(np.asarray(data.y_train[:max_train])).to(dev)
    t = x.shape[1]
    window = tbptt if 0 < tbptt < t else t
    n = x.shape[0]
    bs = min(batch_size, n)
    freeze_from = steps - int(steps * bn_freeze_frac)
    hist = []
    for i in range(steps):
        lo = (i * bs) % (n - bs + 1)
        opt, loss = train_stream_step(
            net, cell, ocfg, opt, x[lo:lo + bs], y[lo:lo + bs],
            window=window, dense=dense, lasso=lasso,
            batch_stats=i < freeze_from)
        hist.append(loss)
    return TrainResult(params=net,
                       losses=torch.stack(hist).tolist() if hist else [])


@torch.no_grad()
def stream_accuracy(cell, params: LUTNet, data, *, folded: bool = False,
                    max_eval: int = 1024,
                    backend: Optional[str] = None) -> float:
    """Sequence-classification accuracy (logits read at the last step), on
    the parameters' device.  ``folded=True`` evaluates the compiled cell's
    integer-code recurrence (the deployed semantics) instead of the
    fake-quant training graph."""
    from repro_torch.stream import cell as cell_mod
    x = np.asarray(data.x_test[:max_eval], np.float32)
    y = np.asarray(data.y_test[:max_eval])
    if folded:
        comp = cell_mod.compile_cell(params, cell, backend=backend)
        _, logits_seq, _ = comp.predict_sequence(x)
    else:
        logits_seq, _ = cell_mod.apply_sequence(params, cell, x,
                                                training=False)
    pred = predicted_classes(logits_seq[:, -1].cpu().numpy())
    return float((pred == y).mean())


# ---------------------------------------------------------------------------
# Population training (the assembly search's scorer)
# ---------------------------------------------------------------------------
#
# Candidates that share a shape signature (``search.space.shape_signature``)
# differ only in their quantizers' bit-widths, which never touch a
# parameter's shape.  Such a group trains at once: the candidates' networks
# are stacked along the unit axis (``assemble.stack_population``), the
# clip bounds are [P] tensors, and each affine stage of the whole group is
# one K4 launch.  BN statistics are per unit, so per (candidate, unit); the
# loss is the sum of the candidates' losses, so each candidate gets its own
# gradient; AdamW clips by each candidate's own norm.  This is a scorer:
# random mappings and no lasso phase; the search re-trains its survivors
# through the full Toolflow.

Bounds = Dict[str, Any]


def quant_bounds(cfg: AssembleConfig) -> Bounds:
    """Per-boundary ``(qmin, qmax)`` clip bounds of one candidate as
    float32 scalar tensors: ``"in"``, ``"layers"`` (one pair a layer) and,
    for additive layers, ``"add"`` keyed by the layer's index."""
    def pair(spec):
        return (torch.tensor(float(spec.qmin)), torch.tensor(float(spec.qmax)))

    out = {"in": pair(cfg.input_quant_spec()),
           "layers": [pair(cfg.quant_spec(l))
                      for l in range(len(cfg.layers))]}
    add = {str(l): pair(cfg.add_quant_spec(l))
           for l in range(len(cfg.layers)) if cfg.layers[l].add_terms > 1}
    if add:
        out["add"] = add
    return out


def _map_bounds(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map_bounds(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_map_bounds(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_bounds(cfgs: Sequence[AssembleConfig]) -> Bounds:
    """Per-candidate bounds stacked into ``[P]`` tensors."""
    return _map_bounds(lambda *xs: torch.stack(xs),
                       *[quant_bounds(c) for c in cfgs])


def slice_bounds(bounds: Bounds, lo: int, hi: int) -> Bounds:
    """Candidates ``lo:hi`` of stacked bounds."""
    return _map_bounds(lambda t: t[lo:hi], bounds)


def population_seeds(seed: int, n: int) -> List[int]:
    """The init seed of each of a group's ``n`` candidates: a function of
    (``seed``, the candidate's index) alone, so a candidate starts from the
    same numbers however its group is sliced."""
    return [int(np.random.SeedSequence([seed, i]).generate_state(1)[0])
            for i in range(n)]


def init_population(seeds: Sequence[int], cfg: AssembleConfig, *,
                    device=None) -> LUTNet:
    """A stacked population whose candidate p is ``assemble.init(seeds[p],
    cfg)`` (random mappings), on ``device`` (CUDA by default)."""
    dev = _device.resolve(device)
    return assemble.stack_population(
        [assemble.init(s, cfg, device="cpu") for s in seeds]).to(dev)


def _scale(q, x: torch.Tensor, lo, hi) -> torch.Tensor:
    """Fake-quantize ``x [batch, P, width]`` with each candidate's
    log-scale and bounds."""
    return quant.fake_quant_dynamic(q.log_scale[:, None], lo[:, None],
                                    hi[:, None], x)


def population_forward(pop: LUTNet, cfg: AssembleConfig, bounds: Bounds,
                       x, *, training: bool) -> torch.Tensor:
    """``assemble.apply`` of every candidate of a stacked population at
    once, on the same rows ``x [batch, in_features]``, with each
    candidate's clip bounds from ``bounds`` ([P] tensors; ``cfg`` supplies
    only the shapes).  Returns logits ``[P, batch, n_out]``; when
    ``training`` the BN running statistics in ``pop`` are refreshed."""
    dev = pop.device
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    bounds = _map_bounds(lambda t: t.to(dev), bounds)
    p = assemble.population_size(pop)
    h = _scale(pop.in_q, x[:, None, :], *bounds["in"])
    for l, spec in enumerate(cfg.layers):
        layer = pop.layers[l]
        xi = assemble.gather_population_inputs(cfg, layer, l, h)
        additive = spec.add_terms > 1
        out = subnet.apply_subnet(
            layer.subnet, cfg.subnet_spec(l), xi,
            activation=False if additive else cfg.has_activation(l),
            training=training)[..., 0]
        out = out.view(out.shape[0], p, -1)
        if additive:
            out = _scale(layer.add_q, out, *bounds["add"][str(l)])
            out = out.reshape(out.shape[0], p, spec.units,
                              spec.add_terms).sum(-1)
            if cfg.has_activation(l):
                out = torch.relu(out)
        h = _scale(layer.out_q, out, *bounds["layers"][l])
    return h.transpose(0, 1)


def _candidate_losses(logits: torch.Tensor, yb: torch.Tensor,
                      binary: bool) -> torch.Tensor:
    """Each candidate's mean loss ``[P]`` over its logits ``[P, batch,
    n_out]`` (the formulas of ``losses``)."""
    logits = logits.to(torch.float32)
    if binary:
        z = logits[..., 0]
        lab = yb.to(torch.float32)[None, :]
        zero = torch.zeros((), dtype=z.dtype, device=z.device)
        abs_z = torch.where(z >= 0, z, -z)
        return torch.mean(torch.maximum(z, zero) - z * lab
                          + torch.log1p(torch.exp(-abs_z)), dim=1)
    logp = torch.log_softmax(logits, dim=-1)
    idx = yb.to(torch.int64)[None, :, None].expand(logits.shape[0], -1, 1)
    return -torch.mean(torch.gather(logp, 2, idx)[..., 0], dim=1)


def _beta_area_proxy(cfg: AssembleConfig, beta: torch.Tensor) -> torch.Tensor:
    """Differentiable stand-in for ``hwcost.network_luts`` as a function of
    the hidden-layer bit-widths ``beta [..., n_layers-1]``: layer l's width
    is layer l+1's address width, priced ``rows * out_bits *
    2^max(beta_l * fan_in - 6, 0)`` (the LUT6 decomposition, smoothed);
    an additive next layer is priced on its branch LUTs."""
    total = torch.zeros(beta.shape[:-1], dtype=torch.float32,
                        device=beta.device)
    zero = torch.zeros((), dtype=torch.float32, device=beta.device)
    for l in range(len(cfg.layers) - 1):
        nxt = cfg.layers[l + 1]
        rows = cfg.mapping_rows(l + 1)
        out_bits = nxt.add_bits if nxt.add_terms > 1 else nxt.bits
        k = beta[..., l] * nxt.fan_in
        total = total + rows * out_bits * 2.0 ** torch.maximum(k - 6.0, zero)
    return total


def bounds_with_rounded_beta(cfg: AssembleConfig, bounds: Bounds,
                             beta) -> Bounds:
    """Stacked ``bounds`` with the hidden layers' clip ranges rebuilt from
    the ROUNDED learned beta ``[P, n_layers-1]``: learned-beta candidates
    are scored on the integer widths a deployed design has."""
    b = quant.round_beta(beta)
    lay = list(bounds["layers"])
    for l in range(b.shape[1]):
        lay[l] = quant.beta_bounds(torch.tensor(b[:, l], dtype=torch.float32),
                                   signed=not cfg.has_activation(l))
    return dict(bounds, layers=lay)


@dataclasses.dataclass
class PopulationResult:
    """A trained group: the stacked population, each candidate's loss
    ``[P, steps]`` (``[P, 1]`` rolled) and, with ``learn_beta``, the
    learned hidden-layer widths ``[P, n_layers-1]``."""

    params: LUTNet
    losses: np.ndarray
    beta: Optional[np.ndarray] = None


def population_step(pop: LUTNet, cfg: AssembleConfig,
                    ocfg: optim.AdamWConfig, opt: optim.AdamWState,
                    bounds: Bounds, xb: torch.Tensor, yb: torch.Tensor, *,
                    beta: Optional[torch.Tensor] = None,
                    proxy0: Optional[torch.Tensor] = None,
                    beta_penalty: float = 0.0, beta_lr: float = 0.0):
    """One step of every candidate: forward (refreshing BN statistics),
    backward of the summed losses, AdamW clipped per candidate.  With
    ``beta [P, n_layers-1]`` the hidden layers' bounds come from it, the
    loss carries ``beta_penalty`` times the area proxy relative to
    ``proxy0``, and beta takes a plain SGD step clipped to [1, 8].  Returns
    (optimizer state, losses ``[P]``, beta); ``pop`` is updated in
    place."""
    for p in pop.parameters():
        p.grad = None
    if beta is not None:
        beta = beta.detach().requires_grad_(True)
        lay = list(bounds["layers"])
        for l in range(len(cfg.layers) - 1):
            lay[l] = quant.beta_bounds(beta[:, l], not cfg.has_activation(l))
        bounds = dict(bounds, layers=lay)
    logits = population_forward(pop, cfg, bounds, xb, training=True)
    loss = _candidate_losses(logits, yb, cfg.layers[-1].units == 1)
    if beta is not None:
        loss = loss + beta_penalty * _beta_area_proxy(cfg, beta) / proxy0
    loss.sum().backward()
    params = assemble.leaves(pop)
    grads = [p.grad if isinstance(p, torch.nn.Parameter) else None
             for p in params]
    opt, _ = optim.adamw_update(ocfg, params, grads, opt,
                                population=assemble.population_size(pop))
    if beta is not None:
        beta = torch.clamp(beta.detach() - beta_lr * beta.grad, 1.0, 8.0)
    return opt, loss.detach(), beta


def _population_run(cfg, bounds, data, *, steps, lr, batch_size,
                    weight_decay, seed, max_train, init_seeds, device,
                    learn_beta=False, beta0=None, beta_penalty=0.0,
                    beta_lr=0.0) -> PopulationResult:
    dev = _device.resolve(device)
    n_cand = int(bounds["in"][0].shape[0])
    seeds = (list(init_seeds) if init_seeds is not None
             else population_seeds(seed, n_cand))
    pop = init_population(seeds, cfg, device=dev)
    bounds = _map_bounds(lambda t: t.to(dev), bounds)
    ocfg = optim.AdamWConfig(lr=lr, weight_decay=weight_decay)
    opt = optim.adamw_init(assemble.leaves(pop))
    x = torch.from_numpy(np.asarray(data.x_train[:max_train])).to(dev)
    y = torch.from_numpy(np.asarray(data.y_train[:max_train])).to(dev)
    n = x.shape[0]
    bs = min(batch_size, n)
    beta = proxy0 = None
    if learn_beta:
        if beta0 is None:
            raise ValueError("learn_beta needs each candidate's beta0")
        beta = torch.as_tensor(np.asarray(beta0, np.float32)).to(dev)
        proxy0 = torch.clamp(_beta_area_proxy(cfg, beta), min=1.0)
    hist = []
    for i in range(steps):
        lo = (i * bs) % (n - bs + 1)
        opt, loss, beta = population_step(
            pop, cfg, ocfg, opt, bounds, x[lo:lo + bs], y[lo:lo + bs],
            beta=beta, proxy0=proxy0, beta_penalty=beta_penalty,
            beta_lr=beta_lr)
        hist.append(loss)
    losses_ = (torch.stack(hist, dim=-1).cpu().numpy() if hist
               else np.zeros((n_cand, 0), np.float32))
    return PopulationResult(
        params=pop, losses=losses_,
        beta=None if beta is None else beta.cpu().numpy())


def train_population(cfg: AssembleConfig, bounds: Bounds, data: Dataset, *,
                     steps: int = 40, lr: float = 5e-3,
                     batch_size: int = 256, weight_decay: float = 1e-4,
                     seed: int = 0, max_train: int = 2048,
                     init_seeds: Optional[Sequence[int]] = None,
                     device=None) -> PopulationResult:
    """Short-horizon training of a shape-signature group, all at once, on
    ``device`` (CUDA by default).  ``bounds`` comes from
    :func:`stack_bounds` (its length is the candidate count); one batch
    schedule is shared, every candidate has its own parameters, optimizer
    moments and bounds.  ``init_seeds`` overrides the candidates' init
    seeds (:func:`population_seeds` of ``seed`` by default); the search
    slices one group's seeds this way."""
    return _population_run(cfg, bounds, data, steps=steps, lr=lr,
                           batch_size=batch_size, weight_decay=weight_decay,
                           seed=seed, max_train=max_train,
                           init_seeds=init_seeds, device=device)


def train_population_rolled(cfg: AssembleConfig, bounds: Bounds,
                            data: Dataset, *, steps: int = 40,
                            lr: float = 5e-3, batch_size: int = 256,
                            weight_decay: float = 1e-4, seed: int = 0,
                            max_train: int = 2048,
                            init_seeds: Optional[Sequence[int]] = None,
                            learn_beta: bool = False, beta0=None,
                            beta_penalty: float = 0.05,
                            beta_lr: float = 0.05,
                            device=None) -> PopulationResult:
    """:func:`train_population` as the search's rung engine: the same batch
    schedule and inits, only the final step's losses kept.  With
    ``learn_beta`` (``beta0 [P, n_layers-1]``, each candidate's hidden
    widths, required) the hidden layers' bit-widths are trained as the
    HGQ-LUT relaxation (:func:`population_step`); beta is left out of
    AdamW, whose weight decay would pull widths toward zero."""
    res = _population_run(cfg, bounds, data, steps=steps, lr=lr,
                          batch_size=batch_size, weight_decay=weight_decay,
                          seed=seed, max_train=max_train,
                          init_seeds=init_seeds, device=device,
                          learn_beta=learn_beta, beta0=beta0,
                          beta_penalty=beta_penalty, beta_lr=beta_lr)
    last = (res.losses[:, -1:] if res.losses.shape[1]
            else np.zeros((res.losses.shape[0], 1), np.float32))
    return dataclasses.replace(res, losses=last)


def predicted_classes(logits: np.ndarray) -> np.ndarray:
    """Classes from logits ``[..., n_out]``: a positive logit is class 1 of
    a single output; otherwise the largest logit's class."""
    if logits.shape[-1] == 1:
        return (logits[..., 0] > 0).astype(np.int32)
    return logits.argmax(-1)


@torch.no_grad()
def population_accuracy(cfg: AssembleConfig, pop: LUTNet, bounds: Bounds,
                        data: Dataset, *, max_eval: int = 1024) -> np.ndarray:
    """Test accuracy of every candidate of a trained group, ``[P]``."""
    y = np.asarray(data.y_test[:max_eval])
    logits = population_forward(pop, cfg, bounds, data.x_test[:max_eval],
                                training=False).cpu().numpy()
    return (predicted_classes(logits) == y[None, :]).mean(axis=-1)


@torch.no_grad()
def accuracy(cfg: AssembleConfig, params: LUTNet, data: Dataset, *,
             folded: bool = False, max_eval: int = 2048) -> float:
    """Test accuracy of the fake-quantized model, or of its folded tables
    (``folded=True``), on the parameters' device."""
    x = torch.from_numpy(np.asarray(data.x_test[:max_eval])).to(params.device)
    y = np.asarray(data.y_test[:max_eval])
    if folded:
        net = folding.fold_network(params, cfg)
        logits = folding.folded_logits(net, x)
    else:
        logits = assemble.apply(params, cfg, x, training=False)
    return float((predicted_classes(logits.cpu().numpy()) == y).mean())


def dense_mlp_reference(data: Dataset, widths: Sequence[int], *,
                        steps: int = 300, lr: float = 3e-3, seed: int = 0,
                        max_train: int = 4096, device=None) -> float:
    """Floating-point fully connected reference (Table II's "FP FC"
    column): plain matrix products, AdamW, test accuracy."""
    dev = _device.resolve(device)
    gen = torch.Generator().manual_seed(seed)
    n_classes = data.n_classes
    dims = ([data.in_features] + list(widths)
            + [1 if n_classes == 2 else n_classes])
    params = []
    for i in range(len(dims) - 1):
        params.append((torch.randn((dims[i], dims[i + 1]), generator=gen)
                       * dims[i] ** -0.5).to(dev).requires_grad_())
        params.append(torch.zeros(dims[i + 1], device=dev,
                                  requires_grad=True))

    def fwd(xb):
        h = xb
        for i in range(0, len(params), 2):
            h = torch.matmul(h, params[i]) + params[i + 1]
            if i < len(params) - 2:
                h = torch.relu(h)
        return h

    ocfg = optim.AdamWConfig(lr=lr)
    opt = optim.adamw_init(params)
    x = torch.from_numpy(np.asarray(data.x_train[:max_train])).to(dev)
    y = torch.from_numpy(np.asarray(data.y_train[:max_train])).to(dev)
    binary = n_classes == 2
    bs = min(256, x.shape[0])
    for i in range(steps):
        lo = (i * bs) % (x.shape[0] - bs + 1)
        for p in params:
            p.grad = None
        logits = fwd(x[lo:lo + bs])
        loss = (losses.binary_cross_entropy(logits, y[lo:lo + bs]) if binary
                else losses.softmax_cross_entropy(logits, y[lo:lo + bs]))
        loss.backward()
        opt, _ = optim.adamw_update(ocfg, params, [p.grad for p in params],
                                    opt)
    with torch.no_grad():
        logits = fwd(torch.from_numpy(
            np.asarray(data.x_test[:2048])).to(dev)).cpu().numpy()
    yt = np.asarray(data.y_test[:2048])
    return float((predicted_classes(logits) == yt).mean())
