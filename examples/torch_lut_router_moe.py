"""The paper's technique as an LM feature, on the PyTorch port: a folded
NeuraLUT-Assemble router in a live MoE layer.

An MoE router is the workload NeuraLUT-Assemble targets: a tiny,
latency-bound classifier.  This example (the port's counterpart of
``examples/lut_router_moe.py``):

  1. trains a small Mixtral-family MoE LM on synthetic tokens through the
     port's train step (``launch.steps.make_train_step``),
  2. collects the router's inputs and top-1 decisions at layer 0,
  3. distills the dense router into a NeuraLUT-Assemble tree with the
     port's ``Toolflow`` (dense pre-train -> learned mappings -> sparse
     retrain),
  4. folds it into L-LUTs and plugs it into ``moe.apply_moe`` through its
     ``router_fn`` hook,
  5. reports routing agreement, the MoE output's error and the folded
     router's hardware cost.

    PYTHONPATH=src python examples/torch_lut_router_moe.py [--device cpu]

Runs on CUDA unless ``--device`` says else.
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs import lm_archs
from repro_torch.core.assemble import AssembleConfig, LayerSpec
from repro_torch.data import synthetic, tokens
from repro_torch.launch import steps
from repro_torch.models import layers, lm, moe
from repro_torch.pipeline import Toolflow
from repro_torch.train import optim


def router_tree_config(d_model: int, n_experts: int) -> AssembleConfig:
    """A LUT tree classifier: d_model inputs -> n_experts logits."""
    return AssembleConfig(
        in_features=d_model, input_bits=2, input_signed=True,
        layers=(
            LayerSpec(8 * n_experts, 4, 2, False),   # learned mappings
            LayerSpec(2 * n_experts, 4, 2, True),    # assemble
            LayerSpec(n_experts, 2, 4, True),        # assemble -> logits
        ),
        subnet_width=16, subnet_depth=2, skip_step=2)


def run(device=None, *, seed: int = 0, lm_steps: int = 40,
        pretrain_steps: int = 100, retrain_steps: int = 300,
        log=print) -> dict:
    """The five steps above on ``device``; returns the LM's first and last
    loss, the routing agreement, the MoE output's relative error and the
    folded router's hardware report."""
    dev = _device.resolve(device)
    cfg = dataclasses.replace(lm_archs.smoke("mixtral-8x22b"),
                              dtype="float32", remat=False)
    log(f"== 1. train a {cfg.n_experts}-expert MoE LM "
        f"({cfg.n_params() / 1e6:.1f}M params) on {dev}")
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    opt = steps.opt_init(params)
    step = steps.make_train_step(cfg, opt_cfg=optim.AdamWConfig(lr=3e-3))
    corpus = tokens.SyntheticCorpus(tokens.TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=16))
    lm_losses = []
    for i in range(lm_steps):
        toks = corpus.sample_batch(i, 16)
        batch = steps.batch_on({"tokens": toks[:, :-1],
                                "labels": toks[:, 1:]}, dev)
        params, opt, m = step(params, opt, batch)
        lm_losses.append(float(m["loss"]))
    log(f"   LM loss: {lm_losses[0]:.3f} -> {lm_losses[-1]:.3f}")

    log("== 2. collect router inputs/decisions at layer 0")
    blk = params.blocks[0]
    mspec = lm.moe_spec(cfg)
    with torch.no_grad():
        toks = torch.from_numpy(corpus.sample_batch(999, 64)[:, :-1]).to(dev)
        x = lm._embed(params, cfg, toks)
        h = layers.rms_norm(x, blk.ln1)
        # the pre-FFN stream: what the router sees
        h2 = layers.rms_norm(x, blk.ln2).reshape(-1, cfg.d_model)
        top1 = torch.argmax(h2 @ blk.moe.router, -1).cpu().numpy()
    h2 = h2.cpu().numpy()
    ds = synthetic.Dataset(name="router", x_train=h2[:1536],
                           y_train=top1[:1536], x_test=h2[1536:],
                           y_test=top1[1536:], n_classes=cfg.n_experts)

    log("== 3. distill into a NeuraLUT-Assemble tree (the paper's flow)")
    flow = Toolflow(router_tree_config(cfg.d_model, cfg.n_experts),
                    pretrain_steps=pretrain_steps,
                    retrain_steps=retrain_steps, lr=1e-2, pretrain_lr=5e-3,
                    lasso=1e-4, sgdr_t0=0, device=dev)
    flow.pretrain(ds).prune().retrain()
    agree = flow.accuracy()
    log(f"   top-1 routing agreement: {agree * 100:.1f}%")

    log("== 4. compile + plug into the live MoE layer")
    compiled = flow.compile()

    def lut_router_fn(xf):
        return compiled.predict(xf.float())

    with torch.no_grad():
        xin = h.float()
        y_dense, _ = moe.apply_moe(blk.moe, mspec, xin)
        y_lut, _ = moe.apply_moe(blk.moe, mspec, xin,
                                 router_fn=lut_router_fn)
        rel = float(torch.linalg.norm(y_dense - y_lut)
                    / torch.clamp(torch.linalg.norm(y_dense), min=1e-9))
    log(f"   MoE output relative diff (dense vs LUT router): {rel:.3f}")

    log("== 5. hardware cost of the folded router")
    rep = compiled.hw_report(pipeline_every=3)
    dense_macs = cfg.d_model * cfg.n_experts
    log(f"   LUT router: {rep.luts} LUTs, {rep.latency_ns:.2f} ns latency, "
        f"0 multipliers (vs {dense_macs} MACs for the dense router)")
    log(f"   area-delay: {rep.area_delay:.0f} LUTxns")
    return {"lm_loss_first": lm_losses[0], "lm_loss_last": lm_losses[-1],
            "routing_agreement": agree, "moe_rel_diff": rel,
            "hwcost": dataclasses.asdict(rep), "dense_router_macs": dense_macs,
            "device": str(dev)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    out = run(args.device, seed=args.seed)
    assert np.isfinite(out["moe_rel_diff"])


if __name__ == "__main__":
    main()
