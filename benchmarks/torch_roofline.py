"""Roofline analysis of the port: the counterpart of ``benchmarks/roofline.py``.

**The dry-run half** (the default) reads the cells of
``experiments/TORCH_dryrun_tp_families.json`` (``launch/dryrun.py``: every
family tensor parallel) and gives per (arch x shape x mesh) cell two time
lower bounds a rank on H100s:

  compute    = flops_per_rank / 989e12             (bf16 dense peak)
  collective = wire_bytes_per_rank / link rate

  * 989e12 FLOP/s: the H100 SXM's dense bf16 tensor-core rate (NVIDIA's
    H100 data sheet; ``chip_smoke.py``'s ``BF16_FLOPS_PER_S``).
  * Link rate: NVLink 4 carries 450 GB/s a direction a card (900 GB/s
    both ways, NVIDIA's H100 SXM data sheet), for meshes of at most 8
    cards (one HGX H100 board); beyond that a card's traffic leaves the
    board through one 400 Gb/s NDR InfiniBand adapter, 50 GB/s (NVIDIA's
    ConnectX-7 data sheet).
  * Wire bytes: each kind's ``collectives.<kind>.bytes`` (rank 0's output
    bytes, counted by ``CommDebugMode``) times the reference's
    ``WIRE_FACTOR`` (all-reduce 2, the others 1).
  * No memory roof: the dry-run records hold no bytes accessed, so
    ``memory_s`` is None with that reason.

``model_flops`` is the reference's (``6 N_active D`` to train, ``2
N_active D`` a prefilled or decoded token), ``useful_ratio`` its share of
the counted flops over every rank, ``roofline_fraction`` the ideal compute
time over the larger roof, and each row keeps the cell's ``design``.

**``--lut``** prints the autotuner's modeled candidate grid
(``autotune.roofline_candidates``: mode, block_b, unit_tile, compute and
memory roofs, the fit in VMEM or, on ``gpu``, in one block's shared memory)
and ``pick_tuning`` for every paper task on ``cpu``, ``tpu`` and ``gpu``,
and writes ``experiments/TORCH_AUTOTUNE_choices.json`` from
``autotune.choice_table``.  Model output only: no training, no timing, no
device.

    python3 benchmarks/torch_roofline.py [RECORD] [--lut [--out PATH]]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import List, Optional

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_FLOPS = 989e12      # H100 SXM dense bf16, FLOP/s a card
NVLINK_BW = 450e9        # NVLink 4, bytes/s a direction a card
IB_BW = 50e9             # 400 Gb/s NDR InfiniBand, bytes/s a card
NVLINK_DOMAIN = 8        # cards that share NVLink (one HGX H100 board)
MEMORY_NOTE = "the dry-run records hold no bytes accessed"

DRYRUN_RECORD = os.path.join(ROOT, "experiments",
                             "TORCH_dryrun_tp_families.json")
LUT_CHOICES_OUT = os.path.join(ROOT, "experiments",
                               "TORCH_AUTOTUNE_choices.json")
LUT_DEVICES = ("cpu", "tpu", "gpu")

WIRE_FACTOR = {
    "all-reduce": 2.0,        # ring: 2(n-1)/n ~= 2
    "all-gather": 1.0,        # (n-1)/n ~= 1
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def load_cells(path: Optional[str] = None) -> List[dict]:
    with open(path or DRYRUN_RECORD) as f:
        return json.load(f)["cells"]


def model_flops(cfg, shape) -> float:
    """Useful flops of the cell (global; forward and backward to train,
    forward to serve)."""
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch   # decode: a token a row


def link_rate(devices: int) -> float:
    """Bytes/s a card's collectives move at, on a mesh of ``devices``."""
    return NVLINK_BW if devices <= NVLINK_DOMAIN else IB_BW


def cell_roofline(rec: dict, cfg, shape) -> Optional[dict]:
    """The roofline row of one dry-run cell (None unless ``ok``)."""
    if rec.get("status") != "ok":
        return None
    devices = math.prod(rec["mesh_shape"])
    flops = rec["flops_per_rank"]
    wire = sum(WIRE_FACTOR[k] * v["bytes"]
               for k, v in rec.get("collectives", {}).items()
               if k in WIRE_FACTOR)
    terms = {"compute_s": flops / PEAK_FLOPS,
             "collective_s": wire / link_rate(devices)}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    flops_global = flops * devices
    bound = max(terms.values())
    ideal = mf / (devices * PEAK_FLOPS)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "design": rec.get("design"), "devices": devices,
        **{k: round(v, 6) for k, v in terms.items()},
        "memory_s": None, "memory_note": MEMORY_NOTE,
        "link_bytes_per_s": link_rate(devices),
        "dominant": dominant.replace("_s", ""),
        "model_flops": mf,
        "flops_global": flops_global,
        "useful_ratio": (round(mf / flops_global, 3) if flops_global
                         else None),
        "roofline_fraction": round(ideal / bound, 3) if bound else None,
    }


def build_table(path: Optional[str] = None) -> List[dict]:
    """One row a cell of the record (skipped cells with their reason)."""
    from repro_torch.configs import lm_archs
    from repro_torch.launch import steps

    rows = []
    for rec in load_cells(path):
        head = {"arch": rec["arch"], "shape": rec["shape"],
                "mesh": rec["mesh"]}
        if rec.get("status") == "skipped":
            rows.append({**head, "status": "skipped",
                         "reason": rec.get("reason", "")})
            continue
        row = cell_roofline(rec, lm_archs.get(rec["arch"]),
                            steps.SHAPES[rec["shape"]])
        rows.append(dict(row, status="ok") if row
                    else {**head, "status": rec.get("status")})
    return rows


def print_table(mesh: str = "single", path: Optional[str] = None
                ) -> List[dict]:
    rows = [r for r in build_table(path) if r["mesh"] == mesh]
    hdr = (f"{'arch':<15} {'shape':<12} {'design':<12} {'comp ms':>9} "
           f"{'coll ms':>9} {'dominant':>10} {'useful':>7} {'roofl%':>7}")
    print(hdr)
    print("-" * len(hdr))
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r.get("status") != "ok":
            print(f"{r['arch']:<15} {r['shape']:<12} "
                  f"{'[' + str(r.get('status')) + ']':>12}")
            continue
        print(f"{r['arch']:<15} {r['shape']:<12} {r['design']:<12} "
              f"{r['compute_s'] * 1e3:9.2f} {r['collective_s'] * 1e3:9.2f} "
              f"{r['dominant']:>10} "
              f"{r['useful_ratio'] if r['useful_ratio'] is not None else '-':>7} "
              f"{(r['roofline_fraction'] or 0) * 100:6.1f}%")
    return rows


# ---------------------------------------------------------------------------
# LUT-cascade roofline (--lut): the kernel autotuner's model, printed
# ---------------------------------------------------------------------------

def task_layers(task: str) -> list:
    """The autotuner's layer tuples of a paper task's config."""
    from repro_torch.configs import paper_tasks
    cfg = paper_tasks.task_config(task)
    layers, off = [], 0
    for l, spec in enumerate(cfg.layers):
        layers.append((cfg.prev_width(l), spec.units,
                       2 ** (cfg.in_bits(l) * spec.fan_in), off,
                       spec.fan_in, cfg.in_bits(l), int(spec.assemble)))
        off += spec.units
    return layers


def print_lut_candidates(task: str = "nid", device: str = "cpu",
                         batch: int = 4096) -> List[dict]:
    """Print the modeled candidate grid for one task's fused cascade."""
    from repro_torch.kernels import autotune

    layers = task_layers(task)
    rows = autotune.roofline_candidates(layers, batch=batch, device=device)
    pick = autotune.pick_tuning(layers, batch=batch, device=device)
    hdr = (f"{'mode':<9} {'block_b':>7} {'tile':>5} {'comp us':>8} "
           f"{'mem us':>8} {'bound':>7} {'rows/s':>12} {'vmem KiB':>9} "
           f"{'fits':>5}")
    print(f"\n=== {task} @ {device} (batch {batch}) ===")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        star = " *" if (r["mode"] == pick.mode
                        and r["block_b"] == pick.block_b
                        and (r["mode"] == "resident"
                             or r["unit_tile"] == pick.unit_tile)) else ""
        vmem = ("-" if r["vmem_bytes"] is None
                else f"{r['vmem_bytes'] / 1024:.0f}")
        print(f"{r['mode']:<9} {r['block_b']:>7} "
              f"{r['unit_tile'] or '-':>5} {r['t_compute_us']:>8.2f} "
              f"{r['t_memory_us']:>8.2f} {r['bound']:>7} "
              f"{r['rows_per_s']:>12,.0f} {vmem:>9} "
              f"{'y' if r['fits_vmem'] else 'N':>5}{star}")
    print(f"pick: mode={pick.mode} block_b={pick.block_b} "
          f"unit_tile={pick.unit_tile} (source={pick.source})")
    return rows


def write_lut_choices(out: str = LUT_CHOICES_OUT,
                      devices=LUT_DEVICES) -> str:
    """Write the per-(task, device) autotuner choice table."""
    from repro_torch.kernels import autotune

    doc = autotune.choice_table(devices=devices)
    out = os.path.abspath(out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    return out


def lut_main(out: str, tasks=None, devices=LUT_DEVICES) -> None:
    from repro_torch.configs import paper_tasks

    for task in tasks or sorted(paper_tasks.TASKS):
        for dev in devices:
            print_lut_candidates(task, dev)
    print(f"\nwrote {write_lut_choices(out, devices)}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("record", nargs="?", default=None,
                    help="dry-run record (default: "
                         "experiments/TORCH_dryrun_tp_families.json)")
    ap.add_argument("--lut", action="store_true",
                    help="the LUT-cascade autotuner roofline instead of the "
                         "dry-run table")
    ap.add_argument("--out", default=LUT_CHOICES_OUT,
                    help="--lut: where to write the choice table JSON")
    args = ap.parse_args()
    if args.lut:
        lut_main(args.out)
        return
    for mesh in ("single", "multi"):
        print(f"\n=== mesh: {mesh} (memory roof: none, {MEMORY_NOTE}) ===")
        print_table(mesh, args.record)


if __name__ == "__main__":
    main()
