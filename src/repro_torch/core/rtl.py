"""Verilog RTL emission for folded NeuraLUT-Assemble networks (§III-B3);
the port's copy of ``repro.core.rtl``, which emits the same bytes.

Each L-LUT becomes a ROM (a ``case`` over the packed address), matching the
paper's toolflow.  Pipeline registers follow the chosen strategy (every
L-LUT layer, or every third layer).  The emitted module is synthesizable and
self-contained, so the hwcost.py model remains externally checkable with any
FPGA toolchain.
"""
from __future__ import annotations

import re
from typing import List

import numpy as np

from repro_torch.core.folding import FoldedNetwork, tables_to_numpy


def _bus(width: int, name: str) -> str:
    return f"[{width - 1}:0] {name}"


def emit_verilog(net: FoldedNetwork, *,
                 module_name: str = "neuralut_assemble",
                 pipeline_every: int = 3) -> str:
    """Emit one synthesizable Verilog module for the folded network.

    Learned mapping indices for non-assemble layers come from
    ``net.mappings``.  Nets without mappings fall back to contiguous
    wiring (correct only for pure-assemble networks and tests).
    """
    cfg = net.cfg
    tables = tables_to_numpy(net)
    lines: List[str] = []
    in_w = cfg.in_features * cfg.input_bits
    out_spec = cfg.layers[-1]
    out_w = out_spec.units * out_spec.bits
    lines.append("// Auto-generated by repro.core.rtl (NeuraLUT-Assemble)")
    lines.append(f"module {module_name} (")
    lines.append("  input  wire clk,")
    lines.append(f"  input  wire {_bus(in_w, 'x')},")
    lines.append(f"  output wire {_bus(out_w, 'y')}")
    lines.append(");")

    prev_sig = "x"
    prev_units = cfg.in_features
    prev_bits = cfg.input_bits
    n_layers = len(cfg.layers)
    for l, spec in enumerate(cfg.layers):
        k = cfg.lut_addr_bits(l)
        w = spec.units * spec.bits
        comb = f"l{l}_c"
        lines.append(f"  // ---- layer {l}: {spec.units} L-LUTs, "
                     f"fan_in={spec.fan_in}, k={k}, out {spec.bits}b ----")
        lines.append(f"  wire {_bus(w, comb)};")
        mapping = None
        if not spec.assemble and net.mappings is not None \
                and net.mappings[l] is not None:
            mapping = np.asarray(net.mappings[l].cpu())
        for u in range(spec.units):
            addr = f"l{l}_a{u}"
            if mapping is not None:
                src_idx = [int(i) for i in mapping[u]]
            else:
                src_idx = [i % prev_units
                           for i in range(u * spec.fan_in,
                                          (u + 1) * spec.fan_in)]
            slices = []
            for i in src_idx:  # MSB-first, matches quant.pack_address
                hi = (i + 1) * prev_bits - 1
                lo = i * prev_bits
                slices.append(f"{prev_sig}[{hi}:{lo}]")
            lines.append(f"  wire {_bus(k, addr)} = {{{', '.join(slices)}}};")
            rom = f"l{l}_r{u}"
            lines.append(f"  reg {_bus(spec.bits, rom)};")
            lines.append("  always @* begin")
            lines.append(f"    case ({addr})")
            for code, val in enumerate(tables[l][u]):
                lines.append(
                    f"      {k}'d{code}: {rom} = {spec.bits}'d{int(val)};")
            lines.append(f"      default: {rom} = {spec.bits}'d0;")
            lines.append("    endcase")
            lines.append("  end")
            hi = (u + 1) * spec.bits - 1
            lo = u * spec.bits
            lines.append(f"  assign {comb}[{hi}:{lo}] = {rom};")
        boundary = l + 1
        registered = (boundary % pipeline_every == 0) or (boundary == n_layers)
        if registered:
            regd = f"l{l}_q"
            lines.append(f"  reg {_bus(w, regd)};")
            lines.append(f"  always @(posedge clk) {regd} <= {comb};")
            prev_sig = regd
        else:
            prev_sig = comb
        prev_units = spec.units
        prev_bits = spec.bits
    lines.append(f"  assign y = {prev_sig};")
    lines.append("endmodule")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Structural LUT counting from emitted Verilog
# ---------------------------------------------------------------------------

_ADDR_RE = re.compile(r"wire \[(\d+):0\] l(\d+)_a(\d+) =")
_ROM_RE = re.compile(r"reg \[(\d+):0\] l(\d+)_r(\d+);")


def count_luts(verilog: str) -> int:
    """LUT6 count implied by an :func:`emit_verilog` module, from the text.

    Walks the emitted ROMs: each `lN_rU` register of width ``b`` driven by
    the `lN_aU` address of width ``k`` maps to ``b * plut_per_bit(k)``
    physical 6-input LUTs (the same Shannon/MUX decomposition the analytic
    model in ``core.hwcost`` assumes).  This is the *independent* leg of
    the hwcost calibration cross-check — it sees only what was actually
    emitted, so a drift between emission and the analytic model surfaces
    as a calibration ratio != 1 (asserted by
    tests/test_hwcost_calibration.py).
    """
    from repro_torch.core import hwcost

    addr_bits = {(int(l), int(u)): int(hi) + 1
                 for hi, l, u in _ADDR_RE.findall(verilog)}
    total = 0
    matched = 0
    for hi, l, u in _ROM_RE.findall(verilog):
        key = (int(l), int(u))
        if key not in addr_bits:
            raise ValueError(f"ROM l{l}_r{u} has no matching address wire")
        total += (int(hi) + 1) * hwcost.plut_per_bit(addr_bits[key])
        matched += 1
    if matched == 0:
        raise ValueError("no ROMs found: not an emit_verilog module?")
    return total
