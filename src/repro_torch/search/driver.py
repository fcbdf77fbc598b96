"""Successive-halving assembly search over (accuracy, area-delay product)
(the port of ``repro.search.driver``).

The paper's method is *choosing* the assembly (fan-in, widths, depth,
beta, skips) per task.  The search:

  1. `generate_candidates` (space.py) enumerates valid variants of the
     task's base design, including additive wide-input units (PolyLUT-Add)
     and the learned-beta relaxation (HGQ-LUT);
  2. candidates are grouped by *(shape signature, learn_beta)* and each
     group (or each of its ``population_slices`` slices) trains as ONE
     stacked population (`lut_trainer.train_population_rolled`: every
     affine stage of the group is one K4 launch on the card) for the
     rung's short horizon; validation
     accuracy is read per candidate (learned-beta groups on ROUNDED
     widths);
  3. survivors are picked by Pareto rank over (rung accuracy, analytic
     area-delay product from `core.hwcost`), so the cheap-but-weak and the
     big-but-strong both stay alive;
  4. after the last rung, candidates are *promoted* in Pareto order to the
     full Toolflow (dense pre-train -> prune -> sparse retrain -> fold),
     producing a `CompiledLUTNetwork` per survivor; promotion continues
     past `budget.promote` (up to `max_promote_extra`) while the frontier
     has fewer than `budget.min_frontier` points.  Learned-beta survivors
     are first snapped to the integer grid and re-validated
     (`space.round_and_validate`); a rounding that breaks the K budget is
     a recorded rejection;
  5. the returned frontier holds the non-dominated promoted points, each
     scored with the *calibrated* ADP (`hwcost.calibrated_report`: the
     analytic model cross-checked against `rtl.emit_verilog`).

Scorer contract: rung training uses random mappings and no lasso phase;
it ranks architectures, it does not produce deployable weights.  Every
deployable artifact on the frontier comes from the full Toolflow.

Devices.  Without a mesh everything runs on ``device`` (CUDA by default).
A mesh is the port's slot mesh (``launch.mesh.make_serving_mesh``): each
slot is an id and the device it runs on, several may share one card.

Distributed path (``mesh=`` / ``DistributedSearchBudget``)
----------------------------------------------------------
Each group's population is cut into ``population_slices`` contiguous
slices; every slice is an independent rolled program
(``lut_trainer.train_population_rolled``) over an explicit slice of the
group's init seeds.  Mesh mode executes the slices on per-slot worker
threads (job j -> slot j % D, each under ``torch.cuda.device`` and the
slot's own stream on a card); single-device mode executes the *same* slice
programs sequentially.  Bit identity of rung survivors between the two
rests on the slice programs being the same (shapes, init seeds, batch
schedule) and on each being deterministic: K4 sums in one fixed order, and
the population's input gather has a fixed-order gradient
(``assemble.gather_population_inputs``).  Identity is NOT claimed against
unsliced training: the slicing itself defines the reference.

Straggler/remesh semantics (``dist/straggler.py``, ``dist/elastic.py``):
after the first worker drains its queue, a deadline of
``straggler_factor x max(job time) + straggler_grace_s`` arms; slices
still unfinished at the deadline are reported as PARTIAL (their
candidates keep the previous rung's accuracy and are flagged in the rung
log) instead of stalling the halving barrier.  A worker whose slot fails
mid-rung consults ``elastic.plan_search_remesh`` and re-enqueues its
slices on the next alive worker; slice programs carry no cross-slot
state, so the replay is bit-identical and the rung converges to the same
survivors.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import hwcost
from repro_torch.core.assemble import AssembleConfig
from repro_torch.search.space import (Candidate, SearchBudget,
                                      generate_candidates,
                                      round_and_validate, shape_signature)


# ---------------------------------------------------------------------------
# Pareto helpers (accuracy: higher is better; adp: lower is better)
# ---------------------------------------------------------------------------

def pareto_frontier(points: Sequence[Tuple[float, float]]) -> List[int]:
    """Indices of the non-dominated points among (accuracy, adp) pairs.

    A point is dominated when another has accuracy >= AND adp <= with at
    least one strict; among exact duplicates the first index wins.
    """
    order = sorted(range(len(points)),
                   key=lambda i: (points[i][1], -points[i][0], i))
    frontier: List[int] = []
    best_acc = None
    for i in order:
        acc, _ = points[i]
        if best_acc is None or acc > best_acc:
            frontier.append(i)
            best_acc = acc
    return sorted(frontier)


def pareto_order(points: Sequence[Tuple[float, float]]) -> List[int]:
    """All indices ordered by Pareto rank (frontier first), accuracy
    descending within a rank — the promotion queue."""
    remaining = list(range(len(points)))
    out: List[int] = []
    while remaining:
        sub = [points[i] for i in remaining]
        front = pareto_frontier(sub)
        picked = [remaining[j] for j in front]
        out.extend(sorted(picked, key=lambda i: -points[i][0]))
        remaining = [i for i in remaining if i not in set(picked)]
    return out


# ---------------------------------------------------------------------------
# Budgets
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistributedSearchBudget(SearchBudget):
    """`SearchBudget` plus the mesh-execution knobs (module docstring)."""

    straggler_factor: float = 4.0   # deadline = factor * max(job dt) + grace
    straggler_grace_s: float = 5.0
    max_slice_retries: int = 2      # re-enqueues per slice before giving up

    @classmethod
    def from_budget(cls, budget: SearchBudget, **kw
                    ) -> "DistributedSearchBudget":
        base = {f.name: getattr(budget, f.name)
                for f in dataclasses.fields(SearchBudget)}
        base.update(kw)
        return cls(**base)


# Fault injection for the executor (tests and chip_smoke.py):
#   {"delay": {slot_idx: seconds}}  — sleep before that slot's first job
#                                     (interruptible by the deadline);
#   {"fail_once": {slot_idx, ...}}  — raise on that slot's first job.
_TEST_HOOKS: dict = {}


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FrontierPoint:
    """One promoted, fully-trained, compiled design on the Pareto frontier."""
    name: str
    cfg: AssembleConfig
    accuracy: float          # folded (bit-exact deployable) test accuracy
    luts: int                # calibrated LUT6 count
    adp: float               # calibrated area-delay product (LUT x ns)
    latency_ns: float
    fmax_mhz: float
    calibration: float       # rtl-parsed / analytic LUT ratio (1.0 = exact)
    rung_accuracy: float     # last short-horizon score (diagnostic)
    compiled: object         # CompiledLUTNetwork (kept untyped: no cycle)
    learned_beta: bool = False  # widths came from the rounded relaxation


@dataclasses.dataclass
class SearchResult:
    task: str
    frontier: List[FrontierPoint]      # ranked by accuracy, descending
    promoted: List[FrontierPoint]      # everything fully trained
    evaluated: List[dict]              # every candidate's rung trajectory
    rejected: List[Tuple[str, str]]    # (name, validity reason)
    seconds: float
    # per-rung log: {"steps", "survivors" (ordered names), "partial"}
    rungs: List[dict] = dataclasses.field(default_factory=list)
    # distributed-execution bookkeeping (None when unsliced):
    # {"mode", "devices", "slices", "straggler_events", "remesh_events",
    #  "partial"}
    dist: Optional[dict] = None
    # wall seconds by stage: "rungs" (one entry a rung), "promotions" (one
    # a promoted candidate: its Toolflow run) and "calibration" (one a
    # promoted candidate: its Verilog emission and calibrated report)
    stage_seconds: dict = dataclasses.field(default_factory=dict)

    def summary(self) -> List[dict]:
        """JSON-ready frontier rows (benchmarks/assembly_search.py)."""
        return [{
            "name": p.name, "accuracy": round(p.accuracy, 4),
            "luts": p.luts, "adp": round(p.adp, 2),
            "latency_ns": round(p.latency_ns, 3),
            "fmax_mhz": round(p.fmax_mhz, 1),
            "calibration": round(p.calibration, 4),
            "layers": [[l.units, l.fan_in, l.bits, l.assemble]
                       for l in p.cfg.layers],
            "additive": any(l.add_terms > 1 for l in p.cfg.layers),
            "learned_beta": p.learned_beta,
        } for p in self.frontier]


# ---------------------------------------------------------------------------
# Rung training
# ---------------------------------------------------------------------------

def _analytic_adp(cfg: AssembleConfig, pipeline_every: int) -> float:
    return hwcost.report(cfg, pipeline_every=pipeline_every).area_delay


def _group_candidates(candidates: List[Candidate]
                      ) -> Dict[tuple, List[Candidate]]:
    """Group by (shape signature, learn_beta): beta-relaxed candidates
    train their bounds, so they never share a stacked group with
    statically-bounded ones."""
    groups: Dict[tuple, List[Candidate]] = {}
    for c in candidates:
        groups.setdefault((shape_signature(c.cfg), c.learn_beta), []).append(c)
    return groups


def _beta0_of(members: List[Candidate]) -> np.ndarray:
    """Init widths of a learn_beta group: each candidate's hidden bits."""
    n_hidden = len(members[0].cfg.layers) - 1
    return np.array([[m.cfg.layers[l].bits for l in range(n_hidden)]
                     for m in members], np.float32)


@dataclasses.dataclass
class _SliceJob:
    """One population slice: an independent rolled training program."""
    members: List[Candidate]
    bounds: dict
    seeds: List[int]             # the members' init seeds, from the group's
    learn_beta: bool
    beta0: Optional[np.ndarray]
    steps: int


def _run_slice(job: _SliceJob, data, budget: SearchBudget, device
               ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    from repro_torch.train import lut_trainer

    cfg = job.members[0].cfg
    res = lut_trainer.train_population_rolled(
        cfg, job.bounds, data, steps=job.steps, lr=budget.lr,
        batch_size=budget.batch_size, max_train=budget.train_rows,
        init_seeds=job.seeds, learn_beta=job.learn_beta, beta0=job.beta0,
        beta_penalty=budget.beta_penalty, beta_lr=budget.beta_lr,
        device=device)
    eval_bounds = job.bounds
    if job.learn_beta:
        eval_bounds = lut_trainer.bounds_with_rounded_beta(
            cfg, job.bounds, res.beta)
    acc = lut_trainer.population_accuracy(
        cfg, res.params, eval_bounds, data, max_eval=budget.eval_rows)
    return np.asarray(acc), res.beta


def _slice_jobs(candidates: List[Candidate], budget: SearchBudget,
                steps: int) -> List[_SliceJob]:
    """Deterministic slice plan: per group, the candidates cut contiguously
    into ceil(n/S)-wide pieces, each carrying its members' init seeds.

    A candidate's seed depends on (budget seed, its index in its group)
    only (``lut_trainer.population_seeds``), never on the slice width, so
    every slicing starts each candidate from the same numbers."""
    from repro_torch.train import lut_trainer

    S = max(budget.population_slices, 1)
    jobs: List[_SliceJob] = []
    for (_, learn_beta), members in _group_candidates(candidates).items():
        bounds = lut_trainer.stack_bounds([m.cfg for m in members])
        seeds = lut_trainer.population_seeds(budget.seed, len(members))
        beta0 = _beta0_of(members) if learn_beta else None
        n = len(members)
        w = math.ceil(n / S)
        for s0 in range(0, n, w):
            s1 = min(s0 + w, n)
            jobs.append(_SliceJob(
                members=members[s0:s1],
                bounds=lut_trainer.slice_bounds(bounds, s0, s1),
                seeds=seeds[s0:s1],
                learn_beta=learn_beta,
                beta0=None if beta0 is None else beta0[s0:s1],
                steps=steps))
    return jobs


class _SliceExecutor:
    """Per-slot worker threads with deterministic job assignment.

    Job j belongs to slot j % D; each worker drains its own queue in
    order, so the set of programs a slot runs is a pure function of the
    job list, not of timing.  Three departures from plain thread-pooling,
    all for the search's semantics:

      * straggler deadline — once the first worker finishes, jobs still
        queued after ``straggler_factor * max(job dt) + grace`` seconds are
        abandoned as PARTIAL (their candidates keep the previous rung's
        score) instead of stalling the halving barrier;
      * slot loss — a worker whose job raises marks its slot dead,
        consults ``elastic.plan_search_remesh``, and re-enqueues its
        remaining jobs (including the failed one) on the next alive worker,
        which replays the same programs bit-identically;
      * per-job timing feeds a ``dist.straggler.StragglerDetector`` so
        slow-but-finishing slices are observable in the event log too.
    """

    def __init__(self, slots: Sequence, budget: "DistributedSearchBudget"):
        self.devices = list(slots)
        self.budget = budget
        # card slots run under their device and a stream of their own;
        # CPU slots are threads of one backend, with nothing to pin
        # (``_pinned``)
        self.streams = [torch.cuda.Stream(device=_slot_device(d))
                        if _slot_device(d).type == "cuda" else None
                        for d in self.devices]
        # a worker thread starts with the process's default intra-op
        # thread count, not the caller's: carry the caller's over, so a
        # slice's CPU reductions split as they do when run sequentially
        self.threads = torch.get_num_threads()
        # a slot lost in one rung stays lost for the rest of the search
        self.dead: set = set()
        hooks = dict(_TEST_HOOKS)
        self.delay = dict(hooks.get("delay", {}))
        self.fail_once = set(hooks.get("fail_once", ()))

    def run(self, jobs: List[_SliceJob], data
            ) -> Tuple[List[Optional[tuple]], dict, set]:
        from repro_torch.dist import elastic, straggler

        D = len(self.devices)
        lock = threading.Lock()
        dead = self.dead
        alive0 = [d for d in range(D) if d not in dead]
        if not alive0:
            raise RuntimeError("no devices left for the population")
        # deterministic assignment over the devices still alive at rung
        # start; mid-rung failures re-route through next_alive below
        queues: Dict[int, List[int]] = {d: [] for d in range(D)}
        for j in range(len(jobs)):
            queues[alive0[j % len(alive0)]].append(j)
        results: List[Optional[tuple]] = [None] * len(jobs)
        running: List[Optional[int]] = [None] * D
        partial: set = set()
        retries = [0] * len(jobs)
        errors: List[BaseException] = []
        stop = threading.Event()
        first_done = threading.Event()
        done_times: List[float] = []
        detector = straggler.StragglerDetector(
            warmup=3, factor=self.budget.straggler_factor)
        events = {"straggler": [], "remesh": []}
        delay = self.delay
        fail_once = self.fail_once
        population = sum(len(j.members) for j in jobs)

        def next_alive(d: int) -> Optional[int]:
            for k in range(1, D + 1):
                cand = (d + k) % D
                if cand not in dead:
                    return cand
            return None

        def abandon(d: int, job_idx: Optional[int]) -> None:
            # caller holds the lock
            left = ([job_idx] if job_idx is not None else []) + queues[d]
            partial.update(left)
            if left:
                events["straggler"].append(
                    {"device": d, "partial_jobs": sorted(left)})
            queues[d].clear()

        def worker(d: int) -> None:
            dev = _slot_device(self.devices[d])
            torch.set_num_threads(self.threads)
            while True:
                with lock:
                    if d in dead or errors:
                        return
                    if stop.is_set():
                        abandon(d, None)
                        return
                    if queues[d]:
                        job_idx = queues[d].pop(0)
                        running[d] = job_idx
                    else:
                        if (all(not q for q in queues.values())
                                and all(r is None or r == running[d]
                                        for r in running)):
                            return  # globally drained, nothing in flight
                        job_idx = None
                if job_idx is None:
                    time.sleep(0.01)  # may still receive remesh re-enqueues
                    continue
                try:
                    if d in delay:
                        # injected straggler: interruptible sleep, so the
                        # deadline abandons the DELAY, never real compute
                        t_end = time.perf_counter() + delay.pop(d)
                        while (time.perf_counter() < t_end
                               and not stop.is_set()):
                            time.sleep(0.01)
                        if stop.is_set():
                            with lock:
                                abandon(d, job_idx)
                                running[d] = None
                            return
                    if d in fail_once:
                        fail_once.discard(d)
                        raise RuntimeError(
                            f"injected device loss on slot {d}")
                    with straggler.StepTimer() as t:
                        with _pinned(dev, self.streams[d]):
                            out = _run_slice(jobs[job_idx], data,
                                             self.budget, dev)
                    with lock:
                        results[job_idx] = out
                        running[d] = None
                        done_times.append(t.dt)
                        detector.observe(job_idx, t.dt)
                        if not queues[d]:
                            first_done.set()
                except Exception as e:  # noqa: BLE001 — device loss path
                    with lock:
                        running[d] = None
                        dead.add(d)
                        alive = D - len(dead)
                        plan = elastic.plan_search_remesh(
                            D, alive, population=population)
                        events["remesh"].append({
                            "device": d, "ok": plan.ok,
                            "new_devices": plan.new_devices,
                            "reason": plan.reason or str(e)})
                        retries[job_idx] += 1
                        if (not plan.ok or retries[job_idx]
                                > self.budget.max_slice_retries):
                            errors.append(e)
                            return
                        tgt = next_alive(d)
                        queues[tgt].extend([job_idx] + queues[d])
                        queues[d].clear()
                    return

        threads = [threading.Thread(target=worker, args=(d,), daemon=True)
                   for d in range(D)]
        for t in threads:
            t.start()
        deadline = None
        while True:
            with lock:
                pending = any(results[j] is None and j not in partial
                              for j in range(len(jobs)))
                failed = bool(errors)
            if not pending or failed:
                break
            if first_done.is_set() and deadline is None:
                with lock:
                    base = max(done_times) if done_times else 0.0
                deadline = (time.perf_counter()
                            + self.budget.straggler_factor * base
                            + self.budget.straggler_grace_s)
            if deadline is not None and time.perf_counter() > deadline:
                stop.set()
                break
            time.sleep(0.02)
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        with lock:
            partial.update(j for j in range(len(jobs))
                           if results[j] is None)
            events["straggler"].extend(detector.events)
        return results, events, partial


def _rung_sliced(candidates: List[Candidate], data,
                 budget: SearchBudget, steps: int,
                 executor: Optional[_SliceExecutor], device
                 ) -> Tuple[Dict[str, float], Dict[str, np.ndarray],
                            List[str], dict]:
    """One rung on the slice plan.  ``executor=None`` runs the identical
    slice programs sequentially on ``device`` (the single-device identity
    reference; one slice a group when ``budget.population_slices <= 1``).

    Returns (accs, betas, partial candidate names, events)."""
    jobs = _slice_jobs(candidates, budget, steps)
    if executor is None:
        results = [_run_slice(job, data, budget, device) for job in jobs]
        events = {"straggler": [], "remesh": []}
        partial_idx: set = set()
    else:
        results, events, partial_idx = executor.run(jobs, data)
    accs: Dict[str, float] = {}
    betas: Dict[str, np.ndarray] = {}
    partial_names: List[str] = []
    for j, job in enumerate(jobs):
        if j in partial_idx or results[j] is None:
            partial_names.extend(m.name for m in job.members)
            continue
        acc, beta = results[j]
        for i, m in enumerate(job.members):
            accs[m.name] = float(acc[i])
            if beta is not None:
                betas[m.name] = beta[i]
    return accs, betas, partial_names, events


# ---------------------------------------------------------------------------
# Promotion
# ---------------------------------------------------------------------------

def _promote(cand: Candidate, data, budget: SearchBudget,
             rung_acc: float, *, device=None,
             seconds: Optional[dict] = None) -> FrontierPoint:
    """Full Toolflow training + compilation + calibrated hardware scoring,
    on ``device``.  ``seconds`` collects the wall time of the Toolflow run
    (``"promotions"``) and of the scoring (``"calibration"``)."""
    from repro_torch import pipeline
    from repro_torch.train import lut_trainer

    t0 = time.perf_counter()
    flow = pipeline.Toolflow(
        cand.cfg, pretrain_steps=budget.pretrain_steps,
        retrain_steps=budget.retrain_steps, lr=budget.lr,
        batch_size=budget.batch_size, lasso=budget.lasso,
        seed=budget.seed, max_train=budget.train_rows, device=device)
    compiled = flow.run(data)
    acc = lut_trainer.accuracy(cand.cfg, flow.params, data, folded=True,
                               max_eval=budget.eval_rows)
    t1 = time.perf_counter()
    # one Verilog emission serves both the ratio and the scaled report
    cal = hwcost.calibration_vs_rtl(compiled.folded(),
                                    pipeline_every=budget.pipeline_every)
    rep = hwcost.calibrated_report(compiled.folded(),
                                   pipeline_every=budget.pipeline_every,
                                   calibration=cal)
    if seconds is not None:
        seconds.setdefault("promotions", []).append(t1 - t0)
        seconds.setdefault("calibration", []).append(
            time.perf_counter() - t1)
    return FrontierPoint(
        name=cand.name, cfg=cand.cfg, accuracy=acc, luts=rep.luts,
        adp=rep.area_delay, latency_ns=rep.latency_ns,
        fmax_mhz=rep.fmax_mhz, calibration=cal["ratio"],
        rung_accuracy=rung_acc, compiled=compiled,
        learned_beta=cand.learn_beta)


def _resolve_promotable(cand: Candidate, betas: Dict[str, np.ndarray],
                        budget: SearchBudget,
                        rejected: List[Tuple[str, str]]
                        ) -> Optional[Candidate]:
    """Snap a learn_beta candidate onto the integer grid before promotion;
    identity for static candidates.  Failures are recorded, never silent."""
    if not cand.learn_beta:
        return cand
    beta = betas.get(cand.name)
    if beta is None:
        rejected.append((cand.name, "post-rounding: no learned beta "
                         "recorded (rung never completed)"))
        return None
    new_cfg, reason = round_and_validate(cand.cfg, beta, budget)
    if new_cfg is None:
        rejected.append((cand.name, reason))
        return None
    return dataclasses.replace(cand, cfg=new_cfg)


def _promote_parallel(items: List[Tuple[Candidate, float]], data,
                      budget: SearchBudget, devices: Sequence,
                      seconds: dict) -> List[FrontierPoint]:
    """Phase-A promotions across the mesh slots (item i -> slot i % D, on
    a card under its device and a stream of its own).  Promotions are
    independent seeded programs, so thread scheduling cannot change the
    results, only the wall-clock."""
    results: List[Optional[FrontierPoint]] = [None] * len(items)
    errors: List[BaseException] = []
    lock = threading.Lock()
    threads_n = torch.get_num_threads()

    def work(i: int) -> None:
        cand, acc = items[i]
        dev = _slot_device(devices[i % len(devices)])
        torch.set_num_threads(threads_n)
        secs: dict = {}
        try:
            stream = torch.cuda.Stream(device=dev) \
                if dev.type == "cuda" else None
            with _pinned(dev, stream):
                results[i] = _promote(cand, data, budget, acc, device=dev,
                                      seconds=secs)
            with lock:
                for k, v in secs.items():
                    seconds.setdefault(k, []).extend(v)
        except Exception as e:  # noqa: BLE001
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=work, args=(i,), daemon=True)
               for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return [p for p in results if p is not None]


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------

def _slot_device(slot) -> torch.device:
    """The device behind a mesh slot (or a device given as is)."""
    return torch.device(getattr(slot, "device", slot))


@contextlib.contextmanager
def _pinned(dev: torch.device, stream):
    """Run on ``dev``: on a card under its device and ``stream``, on the
    CPU as is."""
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield
    stream.synchronize()


def run_search(task: str, budget: Optional[SearchBudget] = None, *,
               data=None, mesh=None, device=None) -> SearchResult:
    """Hardware-aware assembly search for one registered task.

    ``task`` names an entry of ``configs.paper_tasks.TASKS``; ``data``
    overrides the synthetic dataset (tests).  Training runs on ``device``
    (CUDA by default; ``"cpu"`` for the plain path).  ``mesh`` (a slot
    mesh, ``launch.mesh.make_serving_mesh``) turns on the distributed
    path: population slices execute on the mesh's slots with
    straggler-aware rung promotion and elastic remesh, and ``device`` is
    the first slot's.  Without a mesh the slice programs run
    sequentially: ``budget.population_slices > 1`` is the single-device
    identity reference for the mesh run (module docstring), and one slice
    a group is the unsliced search.  See
    `pipeline.Toolflow.search` for the public entry point.
    """
    from repro_torch.configs import paper_tasks
    from repro_torch.data import synthetic

    budget = budget or SearchBudget()
    devices = None
    if mesh is None:
        device = _device.resolve(device)
    else:
        devices = [d for d in mesh.devices.flat]
        device = _slot_device(devices[0])
        if not isinstance(budget, DistributedSearchBudget):
            budget = DistributedSearchBudget.from_budget(budget)
        if budget.population_slices <= 1:
            budget = dataclasses.replace(budget,
                                         population_slices=len(devices))
    executor = (_SliceExecutor(devices, budget) if mesh is not None
                else None)

    t0 = time.time()
    seconds: Dict[str, list] = {"rungs": []}
    base = paper_tasks.task_config(task)
    if data is None:
        data = synthetic.load(paper_tasks.task_dataset(task),
                              n_train=max(budget.train_rows, 2048),
                              n_test=max(budget.eval_rows * 2, 2048))

    candidates, rejected = generate_candidates(base, budget)
    evaluated = [{"name": c.name, "adp_estimate":
                  round(_analytic_adp(c.cfg, budget.pipeline_every), 2),
                  "rungs": {}} for c in candidates]
    by_name = {e["name"]: e for e in evaluated}
    dist_info = None
    if mesh is not None or budget.population_slices > 1:
        dist_info = {"mode": "mesh" if mesh is not None else "sliced",
                     "devices": len(devices) if devices else 1,
                     "slices": budget.population_slices,
                     "straggler_events": [], "remesh_events": [],
                     "partial": []}

    alive = list(candidates)
    accs: Dict[str, float] = {c.name: 0.0 for c in alive}
    betas: Dict[str, np.ndarray] = {}
    rung_log: List[dict] = []
    for steps in budget.rungs:
        t_rung = time.perf_counter()
        new_accs, new_betas, partial, events = _rung_sliced(
            alive, data, budget, steps, executor, device)
        if dist_info is not None:
            dist_info["straggler_events"].extend(events["straggler"])
            dist_info["remesh_events"].extend(events["remesh"])
            dist_info["partial"].extend(partial)
        # partial slices: keep the previous rung's score (the halving
        # barrier does not wait for stragglers)
        accs = {c.name: new_accs.get(c.name, accs.get(c.name, 0.0))
                for c in alive}
        betas.update(new_betas)
        seconds["rungs"].append(time.perf_counter() - t_rung)
        for name, a in accs.items():
            by_name[name]["rungs"][str(steps)] = round(a, 4)
        n_keep = max(min(budget.promote, len(alive)),
                     int(round(len(alive) * budget.keep)))
        points = [(accs[c.name],
                   _analytic_adp(c.cfg, budget.pipeline_every))
                  for c in alive]
        keep_idx = pareto_order(points)[:n_keep]
        alive = [alive[i] for i in keep_idx]
        rung_log.append({"steps": steps,
                         "survivors": [c.name for c in alive],
                         "partial": sorted(partial)})

    # Promotion phase A: the rung survivors, in Pareto order.  Learned-beta
    # survivors are rounded + re-validated first; failures are recorded and
    # the queue moves on.
    points = [(accs.get(c.name, 0.0),
               _analytic_adp(c.cfg, budget.pipeline_every)) for c in alive]
    queue = [alive[i] for i in pareto_order(points)]

    def _wider(c: Candidate) -> bool:
        return c.learn_beta or any(l.add_terms > 1 for l in c.cfg.layers)

    # Diversity slot: rung scores systematically undersell the wider-space
    # candidates (additive units and the beta relaxation pay their training
    # cost up front), so if none made the Pareto queue, the best-scoring
    # wider candidate still gets ONE promotion — the wider space is always
    # explored at full-Toolflow fidelity, never written off on a 16-step
    # score.  Deterministic, and identical across execution modes.
    def _last_rung_acc(name: str) -> float:
        rungs = by_name[name]["rungs"]
        return list(rungs.values())[-1] if rungs else 0.0

    if not any(_wider(c) for c in queue[:budget.promote]):
        wider = [c for c in candidates if _wider(c)]
        if wider:
            pick = max(wider, key=lambda c: _last_rung_acc(c.name))
            at = max(budget.promote - 1, 0)
            queue = ([c for c in queue[:at] if c.name != pick.name] + [pick]
                     + [c for c in queue[at:] if c.name != pick.name])

    phase_a: List[Tuple[Candidate, float]] = []
    for cand in queue:
        if len(phase_a) >= budget.promote:
            break
        resolved = _resolve_promotable(cand, betas, budget, rejected)
        if resolved is not None:
            phase_a.append((resolved, _last_rung_acc(cand.name)))
    if mesh is not None and len(phase_a) > 1:
        promoted = _promote_parallel(phase_a, data, budget, devices, seconds)
    else:
        promoted = [_promote(c, data, budget, a, device=device,
                             seconds=seconds)
                    for c, a in phase_a]

    # Promotion phase B: if full training left the frontier short (rung
    # scores are noisy; mid-range survivors can all come back dominated),
    # fill from the WHOLE evaluated set, preferring candidates whose ADP
    # lies outside the promoted range — a strictly-cheaper design always
    # extends the frontier, a strictly-bigger one does whenever it wins on
    # accuracy.  Bounded by max_promote_extra.
    max_promote = budget.promote + budget.max_promote_extra
    attempted = {c.name for c, _ in phase_a}
    while len(promoted) < max_promote:
        frontier_n = len(pareto_frontier(
            [(p.accuracy, p.adp) for p in promoted]))
        if frontier_n >= budget.min_frontier:
            break
        remaining = [c for c in candidates if c.name not in attempted]
        if not remaining:
            break
        lo = min(p.adp for p in promoted) if promoted else 0.0
        hi = max(p.adp for p in promoted) if promoted else 0.0
        adp_of = {c.name: _analytic_adp(c.cfg, budget.pipeline_every)
                  for c in remaining}
        below = [c for c in remaining if adp_of[c.name] < lo]
        above = [c for c in remaining if adp_of[c.name] > hi]
        pool = below or above or remaining
        cand = max(pool, key=lambda c: _last_rung_acc(c.name))
        attempted.add(cand.name)
        resolved = _resolve_promotable(cand, betas, budget, rejected)
        if resolved is None:
            continue
        promoted.append(_promote(resolved, data, budget,
                                 _last_rung_acc(cand.name), device=device,
                                 seconds=seconds))

    front_idx = pareto_frontier([(p.accuracy, p.adp) for p in promoted])
    frontier = sorted((promoted[i] for i in front_idx),
                      key=lambda p: -p.accuracy)
    return SearchResult(task=task, frontier=frontier, promoted=promoted,
                        evaluated=evaluated, rejected=rejected,
                        seconds=time.time() - t0, rungs=rung_log,
                        dist=dist_info, stage_seconds=seconds)
