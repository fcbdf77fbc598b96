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
Population training (``rolled``) belongs to the search slice.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import assemble, folding
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
    training rows in order, as in the reference."""
    if rolled:
        raise NotImplementedError(
            "rolled training (one fused step loop) belongs to the search "
            "slice (ROADMAP A.13) and is not ported yet")
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
    logits = logits_seq[:, -1].cpu().numpy()
    if cell.n_out == 1:
        pred = (logits[:, 0] > 0).astype(np.int32)
    else:
        pred = logits.argmax(-1)
    return float((pred == y).mean())


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
    logits = logits.cpu().numpy()
    if cfg.layers[-1].units == 1:
        pred = (logits[:, 0] > 0).astype(np.int32)
    else:
        pred = logits.argmax(-1)
    return float((pred == y).mean())


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
    pred = ((logits[:, 0] > 0).astype(np.int32) if binary
            else logits.argmax(-1))
    return float((pred == yt).mean())
