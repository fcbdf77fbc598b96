"""Analytic FPGA cost model: P-LUT area, Fmax, latency, area-delay product
(the port's copy of ``repro.core.hwcost``, numpy only).

The paper measures area/delay with Vivado out-of-context synthesis on a
xcvu9p.  This container has no Vivado, so we model the mapping of L-LUTs
(2^{b_in * F}-entry tables) onto 6-input physical LUTs with Shannon/MUX
decomposition — the same structural mapping logic synthesis performs — and
calibrate the timing model's three constants against the paper's own eight
Table III measurements (least-squares, see ``fit_timing``).  ``core/rtl.py``
emits real Verilog so the numbers remain externally checkable.

Decomposition model (per output bit of one L-LUT with k address bits):
  k <= 6 : 1 LUT6
  k == 7 : 2 LUT6 (+ MUXF7, free)
  k == 8 : 4 LUT6 (+ 2 MUXF7 + MUXF8, free)
  k >  8 : 2^(k-6) LUT6 cofactors + a 4:1-mux tree (each 4:1 mux = 1 LUT6)
           combining the 2^(k-8) MUXF8 groups.

Logic levels: 1 for k<=6; 1.5 for k in (7, 8) (the MUXF pair adds about half
a LUT delay); beyond 8 each 4:1-mux tree level adds a full level.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.assemble import AssembleConfig


def plut_per_bit(k: int) -> int:
    """#LUT6 per output bit of a k-address-bit L-LUT."""
    if k <= 6:
        return 1
    if k == 7:
        return 2
    if k == 8:
        return 4
    cof = 2 ** (k - 6)
    groups = 2 ** (k - 8)
    muxes = 0
    while groups > 1:
        m = math.ceil(groups / 4)
        muxes += m if groups > 4 else 1
        groups = m
    return cof + muxes


def logic_levels(k: int) -> float:
    """Logic levels of a k-address-bit L-LUT (1, 1.5, then one more per
    4:1-mux tree level)."""
    if k <= 6:
        return 1.0
    if k <= 8:
        return 1.5
    groups = 2 ** (k - 8)
    return 1.5 + math.ceil(math.log(groups, 4))


def layer_luts(cfg: AssembleConfig, l: int) -> int:
    """#LUT6 of layer ``l``."""
    spec = cfg.layers[l]
    k = cfg.lut_addr_bits(l)
    return spec.units * spec.bits * plut_per_bit(k)


def network_luts(cfg: AssembleConfig) -> int:
    """#LUT6 of the whole network."""
    return sum(layer_luts(cfg, l) for l in range(len(cfg.layers)))


def network_ffs(cfg: AssembleConfig, pipeline_every: int) -> int:
    """Flip-flops: one register per bit at each registered layer boundary.

    ``pipeline_every`` = 1 registers every L-LUT layer; 3 registers every
    third boundary (the paper's two strategies, Table III)."""
    n = len(cfg.layers)
    total = 0
    for l in range(n):
        boundary = l + 1  # after layer l
        if boundary % pipeline_every == 0 or boundary == n:
            total += cfg.layers[l].units * cfg.layers[l].bits
    return total


# ---------------------------------------------------------------------------
# Timing model, calibrated on the paper's Table III
# ---------------------------------------------------------------------------

# (total LUTs, max k over layers, pipeline_every, measured period ns)
PAPER_TABLE3 = [
    ("mnist",  5040, 6, 1, 1e3 / 916),
    ("mnist",  5037, 6, 3, 1e3 / 849),
    ("jsc_cb", 8535, 8, 1, 1e3 / 994),
    ("jsc_cb", 8539, 8, 3, 1e3 / 352),
    ("jsc_oml", 1844, 6, 1, 1e3 / 1067),
    ("jsc_oml", 1780, 6, 3, 1e3 / 941),
    ("nid",    95,   6, 1, 1e3 / 1479),
    ("nid",    91,   6, 3, 1e3 / 1471),
]


def _effective_levels(k: int, pipeline_every: int) -> float:
    """Logic levels per pipeline stage after Vivado retiming.

    k<=6 L-LUT chains retime freely, so a stage behaves like ~1 level
    regardless of strategy; k>6 L-LUTs are ROM cones that cannot be split,
    so a stage carries pipeline_every * levels(k) (observed: JSC-CERNBox
    Fmax collapses 994->352 MHz only for the wide-k model)."""
    if k <= 6:
        return 1.0
    return logic_levels(k) * pipeline_every


def fit_timing() -> Tuple[float, float, float]:
    """Least-squares fit of  period = a + b*log10(luts) + c*eff_levels ."""
    rows = np.array([
        [1.0, math.log10(r[1]), _effective_levels(r[2], r[3])]
        for r in PAPER_TABLE3
    ])
    y = np.array([r[4] for r in PAPER_TABLE3])
    coef, *_ = np.linalg.lstsq(rows, y, rcond=None)
    return float(coef[0]), float(coef[1]), float(coef[2])


_COEF = None


def clock_period_ns(cfg: AssembleConfig, pipeline_every: int) -> float:
    """Modelled clock period (ns) from the fitted timing constants."""
    global _COEF
    if _COEF is None:
        _COEF = fit_timing()
    a, b, c = _COEF
    luts = max(network_luts(cfg), 1)
    kmax = max(cfg.lut_addr_bits(l) for l in range(len(cfg.layers)))
    period = a + b * math.log10(luts) + c * _effective_levels(kmax,
                                                              pipeline_every)
    return max(period, 0.4)  # floor: FPGA global clock limits


@dataclasses.dataclass(frozen=True)
class HwReport:
    """LUTs, flip-flops, Fmax, cycles, latency and area-delay product."""

    luts: int
    ffs: int
    fmax_mhz: float
    cycles: int
    latency_ns: float
    area_delay: float  # LUT x ns, the paper's figure of merit


def report(cfg: AssembleConfig, pipeline_every: int = 3) -> HwReport:
    """The analytic hardware report of ``cfg`` (additive layers priced as
    their lowered branch and combiner pair)."""
    # cost is a property of the *hardware* form: additive layers are priced
    # as their lowered branch + combiner pair (matches what rtl.py receives,
    # since fold_network emits a lowered FoldedNetwork)
    from repro_torch.core import assemble
    cfg = assemble.lower_additive(cfg)
    luts = network_luts(cfg)
    ffs = network_ffs(cfg, pipeline_every)
    period = clock_period_ns(cfg, pipeline_every)
    cycles = math.ceil(len(cfg.layers) / pipeline_every)
    latency = cycles * period
    return HwReport(luts=luts, ffs=ffs, fmax_mhz=1e3 / period, cycles=cycles,
                    latency_ns=latency, area_delay=luts * latency)


# ---------------------------------------------------------------------------
# Calibration against actual RTL emission (assembly-search ADP scoring)
# ---------------------------------------------------------------------------

def calibration_vs_rtl(net, pipeline_every: int = 3) -> dict:
    """Cross-check the analytic LUT count against real Verilog emission.

    ``net`` is a ``FoldedNetwork``.  Emits the module with ``core.rtl`` and
    structurally counts LUT6s from the text (``rtl.count_luts``), returning
    ``{"analytic_luts", "rtl_luts", "ratio"}`` with
    ``ratio = rtl / analytic``.  The two legs share only ``plut_per_bit``;
    any divergence in what is emitted vs what is modeled (layer widths,
    address packing, ROM output bits) shows up as ``ratio != 1``.  The
    assembly search multiplies its analytic ADP estimates by this ratio for
    the final frontier scores (DESIGN.md §8).
    """
    from repro_torch.core import rtl

    analytic = network_luts(net.cfg)
    counted = rtl.count_luts(
        rtl.emit_verilog(net, pipeline_every=pipeline_every))
    return {"analytic_luts": analytic, "rtl_luts": counted,
            "ratio": counted / max(analytic, 1)}


def calibrated_report(net, pipeline_every: int = 3,
                      calibration: dict = None) -> HwReport:
    """:func:`report` with the LUT count (and hence area-delay product)
    scaled by the RTL-emission cross-check ratio.

    Pass a precomputed :func:`calibration_vs_rtl` result as
    ``calibration`` to avoid re-emitting the (potentially multi-MB)
    Verilog; it must come from the same ``pipeline_every``.
    """
    rep = report(net.cfg, pipeline_every=pipeline_every)
    if calibration is None:
        calibration = calibration_vs_rtl(net, pipeline_every=pipeline_every)
    luts = int(round(rep.luts * calibration["ratio"]))
    return dataclasses.replace(rep, luts=luts,
                               area_delay=luts * rep.latency_ns)


def tree_area(fan_ins: Sequence[int], bits: int, out_bits: int = None) -> int:
    """LUT6 area of ONE assembled tree (Fig. 2 / Fig. 5 analysis).

    ``fan_ins[i]`` is the per-unit fan-in at tree level i (leaves first);
    level i has prod(fan_ins[i+1:]) units.  ``bits`` is the activation
    bit-width at every level.
    """
    out_bits = bits if out_bits is None else out_bits
    total = 0
    n_levels = len(fan_ins)
    for i, f in enumerate(fan_ins):
        n_units = 1
        for g in fan_ins[i + 1:]:
            n_units *= g
        ob = out_bits if i == n_levels - 1 else bits
        total += n_units * ob * plut_per_bit(bits * f)
    return total
