"""The JAX package's paper tables at several seeds, as the record that
``benchmarks/torch_paper_tables.py --against`` holds the port to.

Runs the reference's own ``benchmarks/paper_tables.py`` functions
(``table2``, ``table3``, ``table4``, ``fig2_assembly_scaling``, ``fig5``)
on the CPU, unedited.  ``table2`` and ``table4`` train at seed 0 in that
file; each further seed reruns them with the seed bound into the two
trainers they call (``_train_with_learned_mappings`` and the
``lut_trainer`` functions ``train`` and ``dense_mlp_reference``), so every
row is what the file computes at that seed.  ``fig5`` takes its seeds.

    JAX_PLATFORMS=cpu PYTHONPATH=src:. python \
        experiments/TORCH_paper_tables_reference.py [--seeds 0,1,2] \
        [--tables table2,table3,table4,fig2,fig5] [--out PATH]

Writes ``experiments/TORCH_paper_tables_reference.json`` by default: per
table the rows of every seed (``per_seed``) or the rows (``rows``), its
seconds, the seeds and this command.  ``--merge`` adds further seeds of
``table2`` / ``table4`` to that record (``seeds`` keeps the first run's;
``merged`` lists the commands).  Imports JAX; the port never imports
this file.
"""
from __future__ import annotations

import argparse
import functools
import json
import platform
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

DEFAULT_OUT = ROOT / "experiments" / "TORCH_paper_tables_reference.json"
TABLES = ("table2", "table3", "table4", "fig2", "fig5")


def _at_seed(pt, seed: int):
    """Bind ``seed`` into the trainers ``table2`` and ``table4`` call;
    returns a function that restores them."""
    orig_flow, orig_lt = pt._train_with_learned_mappings, pt.lut_trainer
    pt._train_with_learned_mappings = functools.partial(orig_flow, seed=seed)
    proxy = types.SimpleNamespace(**vars(orig_lt))
    proxy.train = functools.partial(orig_lt.train, seed=seed)
    proxy.dense_mlp_reference = functools.partial(
        orig_lt.dense_mlp_reference, seed=seed)
    pt.lut_trainer = proxy

    def restore():
        pt._train_with_learned_mappings, pt.lut_trainer = orig_flow, orig_lt
    return restore


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--tables", default=",".join(TABLES))
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--merge", action="store_true",
                    help="add the seeds of table2 / table4 to the record "
                         "already at --out (the other tables stay)")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    tables = args.tables.split(",")

    import jax
    from benchmarks import paper_tables as pt

    command = ("JAX_PLATFORMS=cpu PYTHONPATH=src:. python "
               "experiments/TORCH_paper_tables_reference.py "
               + " ".join(sys.argv[1:]))
    if args.merge:
        rec = json.loads(Path(args.out).read_text())
        rec["merged"] = rec.get("merged", []) + [command]
    else:
        rec = {"package": "repro (JAX reference), CPU", "command": command,
               "jax": jax.__version__, "machine": platform.machine(),
               "seeds": seeds, "steps": pt.STEPS}
    for name in tables:
        t0 = time.perf_counter()
        if name in ("table2", "table4"):
            per_seed = {}
            for s in seeds:
                restore = _at_seed(pt, s)
                try:
                    per_seed[str(s)] = getattr(pt, name)()
                finally:
                    restore()
                print(f"{name} seed {s}: {per_seed[str(s)]}", flush=True)
            if args.merge:
                rec[name]["per_seed"].update(per_seed)
                rec[name].setdefault("merged_seconds", []).append(
                    time.perf_counter() - t0)
            else:
                rec[name] = {"per_seed": per_seed}
        elif name == "fig5":
            rec[name] = {"rows": pt.fig5(seeds=tuple(seeds))}
        elif name == "fig2":
            rec[name] = {"rows": pt.fig2_assembly_scaling()}
        else:
            rec[name] = {"rows": getattr(pt, name)()}
        if not args.merge:
            rec[name]["seconds"] = time.perf_counter() - t0
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
