"""K1's and K2's plans and their split of the cascade, on the CPU.

``plan_resident`` and ``plan_cluster`` are plain Python: how many rows a
tile, how many CTAs, what one CTA holds in shared memory and (K2) which
units each CTA owns.  The kernels themselves run only on the card; here
numpy emulations of what their CTAs do are held bit for bit against
``lut_cascade_plain`` and the reference's Pallas kernels (interpret mode):
K1's persistent CTAs walking tiles of contiguous int32 code spans, layer
by layer in groups of units (layer 0 from the int32 codes, later layers
from activation tiles of the narrow dtype); K2's CTAs each
forming the addresses of their own units from their own copy of the
activation tile, reading only their share of the tables (granule by
granule on the ring route) and writing their codes into every CTA's copy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pipeline as jpipeline
from repro.configs import paper_tasks as jtasks
from repro.kernels.lut_cascade import lut_cascade_pallas
from repro_torch.configs import paper_tasks
from repro_torch.kernels import autotune
from repro_torch.kernels import lut_cascade as lc


def _layers(task):
    """v2 layer tuples of a paper task, as the fused plan carries them."""
    cfg = paper_tasks.task_config(task)
    layers, off = [], 0
    for l, spec in enumerate(cfg.layers):
        layers.append((cfg.prev_width(l), spec.units,
                       2 ** (cfg.in_bits(l) * spec.fan_in), off, spec.fan_in,
                       cfg.in_bits(l), int(spec.assemble)))
        off += spec.units
    return tuple(layers)


# a cascade whose tables (6-input L-LUTs on 2-bit codes: 4,096 entries)
# exceed any CTA's share: the ring route
RING_LAYERS = ((784, 512, 4096, 0, 6, 2, 0), (512, 64, 4096, 512, 6, 2, 0),
               (64, 16, 256, 576, 4, 2, 1))


def _covers(plan, layers):
    """Every CTA's ranges tile each layer's units in order, GROUP-aligned."""
    for l, layer in enumerate(layers):
        spans = [plan.ranges[c][l] for c in range(plan.cluster)]
        assert spans[0][0] == 0 and spans[-1][1] == layer[1]
        for (lo, hi), (lo2, _) in zip(spans, spans[1:]):
            assert hi == lo2 and lo <= hi
        assert all(lo % lc.GROUP == 0 for lo, hi in spans if lo < hi)
    assert plan.input_ranges[-1][1] == layers[0][0]


@pytest.mark.parametrize("task,itemsize,cluster,rows,smem", [
    ("mnist", 1, 4, 16, 177_344), ("mnist", 2, 8, 16, 165_760),
    ("mnist", 4, 8, 8, 214_592), ("nid", 1, 4, 32, 40_880),
    ("jsc_cernbox", 2, 4, 32, 107_072), ("jsc_openml", 2, 4, 32, 42_560),
])
def test_plan_cluster_on_paper_tasks(task, itemsize, cluster, rows, smem):
    """Resident, on a cluster of 4 where a CTA then holds its share and 16
    rows in 232,448 B, else of 8; the most rows that fit."""
    layers = _layers(task)
    plan = lc.plan_cluster(layers, itemsize)
    assert (plan.cluster, plan.rows, plan.route) == (cluster, rows,
                                                     "resident")
    assert plan.smem_bytes == smem <= lc.SMEM_PER_BLOCK
    assert plan.smem_bytes == lc.cluster_smem_bytes(layers, itemsize,
                                                    cluster, rows)
    _covers(plan, layers)


def test_plan_cluster_mnist_shares():
    """mnist at C = 8: 272 units of each 2160-unit layer a CTA (the last
    one 256), 48 of the 360s; 32 rows fit."""
    plan = lc.plan_cluster(_layers("mnist"), 1, cluster=8)
    assert (plan.rows, plan.smem_bytes) == (32, 193_280)
    assert [plan.ranges[c][0] for c in (0, 7)] == [(0, 272), (1904, 2160)]
    assert [plan.ranges[c][1] for c in (0, 7)] == [(0, 48), (336, 360)]
    assert plan.ranges[7][5] == (10, 10)              # 10 units: CTAs 0-2
    assert plan.input_ranges[0] == (0, 100)
    assert lc.cluster_share(2160, 8) == 272


@pytest.mark.parametrize("unit_tile,ring_units", [(1, 4), (6, 8), (16, 16),
                                                  (20, 20)])
def test_plan_cluster_takes_the_ring_where_the_share_does_not_fit(
        unit_tile, ring_units):
    plan = lc.plan_cluster(RING_LAYERS, 1, unit_tile=unit_tile)
    assert plan.route == "ring" and plan.ring_units == ring_units
    assert plan.rows == lc.CLUSTER_ROWS
    assert plan.smem_bytes <= lc.SMEM_PER_BLOCK
    assert lc.cluster_smem_bytes(RING_LAYERS, 1, 8, 8) > lc.SMEM_PER_BLOCK
    _covers(plan, RING_LAYERS)
    # mnist's int8 tables at a cluster of 2: the share does not fit either
    assert lc.plan_cluster(_layers("mnist"), 1, cluster=2, rows=8).route \
        == "ring"
    # wider tables: two stages of 32 units do not fit; the granule shrinks
    for itemsize, units in ((2, 8), (4, 4)):
        wide = lc.plan_cluster(RING_LAYERS, itemsize, unit_tile=32)
        assert (wide.route, wide.ring_units) == ("ring", units)
        assert wide.smem_bytes <= lc.SMEM_PER_BLOCK


def test_plan_cluster_refuses_what_fits_nowhere():
    wide = ((16, 8, 2 ** 17, 0, 1, 17, 0),)
    with pytest.raises(ValueError, match="no K2 plan"):
        lc.plan_cluster(wide, 4)
    with pytest.raises(ValueError, match="cluster 9"):
        lc.plan_cluster(_layers("nid"), 1, cluster=9)


def _emulate(codes, tables, maps, layers, plan):
    """What K2's CTAs compute, CTA by CTA: returns the output codes."""
    codes = codes.numpy().astype(np.int64)
    tab = tables.numpy().astype(np.int64)
    b = codes.shape[0]
    out = np.full((b, layers[-1][1]), -1, np.int64)
    granule = plan.ring_units or max(l[1] for l in layers)
    for b0 in range(0, b, plan.rows):
        rows = min(plan.rows, b - b0)
        h = np.zeros((plan.cluster, rows, plan.a_pad), np.int64)
        for lo, hi in plan.input_ranges:          # each CTA's columns to all
            h[:, :, lo:hi] = codes[b0:b0 + rows, lo:hi]
        for l, (_, units, entries, off, fan, bits, asm) in enumerate(layers):
            hn = np.zeros_like(h)
            for c in range(plan.cluster):
                lo, hi = plan.ranges[c][l]
                share = tab[off + lo:off + hi]    # this CTA's table rows
                for g0 in range(lo, hi, granule):
                    u = np.arange(g0, min(g0 + granule, hi))
                    if asm:
                        src = u[:, None] * fan + np.arange(fan)
                    else:
                        src = maps[l].numpy()[u]
                    a = np.zeros((rows, len(u)), np.int64)
                    for f in range(fan):
                        a = (a << bits) + h[c][:, src[:, f]]
                    a = np.minimum(a, entries - 1)
                    val = share[u - lo, a]
                    if l == len(layers) - 1:
                        out[b0:b0 + rows, u] = val
                    else:
                        hn[:, :, u] = val           # into every CTA's copy
            h = hn
    return torch.from_numpy(out.astype(np.int32))


def _random_cascade(layers, seed):
    """Random packed tables (each layer's codes below 2^bits of the next
    layer's input) and maps."""
    rs = np.random.RandomState(seed)
    tab = np.zeros((sum(l[1] for l in layers), max(l[2] for l in layers)),
                   np.int32)
    maps = []
    for l, (prev, units, entries, off, fan, bits, asm) in enumerate(layers):
        out_bits = layers[l + 1][5] if l + 1 < len(layers) else 3
        tab[off:off + units, :entries] = rs.randint(0, 2 ** out_bits,
                                                    (units, entries))
        maps.append(None if asm else torch.from_numpy(
            rs.randint(0, prev, (units, fan)).astype(np.int32)))
    return torch.from_numpy(tab), maps


@pytest.mark.parametrize("case", ["mnist", "nid", "jsc_cernbox",
                                  "ring unit_tile 8", "ring unit_tile 1",
                                  "mnist cluster 3 rows 5"])
def test_cluster_emulation_equals_plain_bit_for_bit(case):
    layers = RING_LAYERS if case.startswith("ring") else _layers(
        case.split()[0])
    kw = {}
    if case.startswith("ring"):
        kw["unit_tile"] = int(case.split()[-1])
    if "cluster 3" in case:
        kw.update(cluster=3, rows=5)
    plan = lc.plan_cluster(layers, 1, **kw)
    assert plan.route == ("ring" if case.startswith("ring") else "resident")
    tables, maps = _random_cascade(layers, seed=len(case))
    codes = torch.from_numpy(np.random.RandomState(3).randint(
        0, 2 ** layers[0][5], (37, layers[0][0])).astype(np.int32))
    want = lc.lut_cascade_plain(codes, tables, maps, layers)
    assert torch.equal(_emulate(codes, tables, maps, layers, plan), want)


def test_cluster_emulation_equals_reference_streamed_kernel():
    """nid_reduced's fused plan, split over a cluster of 4 with tiles of
    8 rows, against the reference's streamed Pallas kernel."""
    cfg = jtasks.task_config("nid_reduced")
    rs = np.random.RandomState(4)
    tables, maps = [], []
    for l, spec in enumerate(cfg.layers):
        entries = 2 ** (cfg.in_bits(l) * spec.fan_in)
        tables.append(rs.randint(0, 2 ** spec.bits, (spec.units, entries)
                                 ).astype(np.int32))
        maps.append(None if spec.assemble else rs.randint(
            0, cfg.prev_width(l), (spec.units, spec.fan_in)).astype(np.int32))
    jnet = jpipeline.CompiledLUTNetwork(cfg, tables, maps, -1.0, -1.0)
    plan = jnet.compile_backend("fused").plan
    layers = tuple(tuple(int(v) for v in l) for l in plan.meta["layers"])
    codes = rs.randint(0, 2 ** layers[0][5], (33, layers[0][0])
                       ).astype(np.int32)
    want = np.asarray(lut_cascade_pallas(
        jnp.asarray(codes), jnp.asarray(plan.buffers["amat"]),
        jnp.asarray(plan.buffers["tables"]), layers=layers, block_b=16,
        mode="streamed", unit_tile=8, interpret=True))
    tmaps = [torch.from_numpy(plan.buffers[f"map_{l}"])
             if f"map_{l}" in plan.buffers else None
             for l in range(len(layers))]
    got = _emulate(torch.from_numpy(codes),
                   torch.from_numpy(plan.buffers["tables"]), tmaps, layers,
                   lc.plan_cluster(layers, 1, cluster=4, rows=8))
    np.testing.assert_array_equal(got.numpy(), want)


# every (task, table itemsize) that hopper_mode sends to K1
RESIDENT = [(t, isz) for t in paper_tasks.TASKS for isz in (1, 2, 4)
            if autotune.hopper_mode(_layers(t), isz) == "resident"]


@pytest.mark.parametrize("task,itemsize", RESIDENT)
def test_plan_resident_fits_every_task_hopper_mode_sends_to_k1(task,
                                                              itemsize):
    """A plan at every batch, within one block's shared memory; rows a
    multiple of 4 (so every tile's int32 codes start 16-byte aligned, odd
    W0 included); the grid never above the tiles nor sms x CTAs an SM."""
    layers = _layers(task)
    w0 = layers[0][0]
    for batch in (1, 3, 37, 1024, 4096, 65536):
        for sms in (1, 7, 132):
            plan = lc.plan_resident(layers, itemsize, batch, sms)
            assert plan.smem_bytes == lc.resident_smem_bytes(
                layers, itemsize, plan.rows) <= lc.SMEM_PER_BLOCK
            assert plan.rows % 4 == 0
            assert lc.RESIDENT_MIN_ROWS <= plan.rows <= lc.RESIDENT_MAX_ROWS
            assert plan.tiles == -(-batch // plan.rows)
            assert 1 <= plan.grid <= min(plan.tiles, sms * plan.ctas_per_sm)
            assert plan.ctas_per_sm * lc.RESIDENT_THREADS <= lc.THREADS_PER_SM
            assert plan.ctas_per_sm * (plan.smem_bytes
                                       + lc.SMEM_PER_CTA_RESERVED) \
                <= lc.SMEM_PER_SM
            assert all(t * plan.rows * w0 * 4 % 16 == 0
                       for t in range(plan.tiles))
            assert plan.a_pad >= lc.act_width(layers) and plan.a_pad % 4 == 0


@pytest.mark.parametrize("task,itemsize,batch,rows,ctas,grid,smem", [
    ("nid", 1, 1024, 8, 4, 128, 55_152), ("nid", 1, 1, 4, 7, 1, 31_408),
    ("nid", 1, 4096, 16, 2, 256, 102_640),
    ("nid", 1, 65536, 16, 2, 264, 102_640),
    ("jsc_openml", 2, 1024, 8, 2, 128, 88_992),
    ("jsc_openml", 2, 4096, 16, 2, 256, 95_200),
    ("jsc_cernbox", 1, 1024, 8, 1, 128, 170_272),
])
def test_plan_resident_on_paper_tasks(task, itemsize, batch, rows, ctas, grid,
                                      smem):
    """The fewest rows (a multiple of 4, 4 to 16) that leave at most one
    tile an SM of 132; every CTA that fits by shared memory and threads, at
    most one a tile.  nid's odd W0 = 593 pads its uint8 activation rows to
    596 codes (149 words)."""
    plan = lc.plan_resident(_layers(task), itemsize, batch, 132)
    assert (plan.rows, plan.ctas_per_sm, plan.grid, plan.smem_bytes) == (
        rows, ctas, grid, smem)
    if task == "nid":
        assert plan.a_pad == 596 and plan.a_pad // 4 % 2 == 1


def test_plan_resident_pins_and_refusals():
    layers = _layers("nid")
    plan = lc.plan_resident(layers, 1, 1024, 132, rows=16, ctas_per_sm=2)
    assert (plan.rows, plan.ctas_per_sm, plan.grid, plan.tiles) == (
        16, 2, 64, 64)
    assert lc.plan_resident(layers, 1, 1024, 2, rows=4,
                            ctas_per_sm=1).grid == 2
    with pytest.raises(ValueError, match="multiple of 4"):
        lc.plan_resident(layers, 1, 1024, 132, rows=6)
    with pytest.raises(ValueError, match="CTAs an SM"):
        lc.plan_resident(layers, 1, 1024, 132, rows=32, ctas_per_sm=2)
    assert lc.plan_resident(layers, 1, 1024, 132, rows=32).ctas_per_sm == 1
    # mnist's tables go to K2: K1 has no plan for them, as hopper_mode says
    assert autotune.hopper_mode(_layers("mnist"), 1) == "streamed"
    with pytest.raises(ValueError, match="shared memory"):
        lc.plan_resident(_layers("mnist"), 1, 1024, 132)


def _emulate_resident(codes, tables, maps, layers, plan):
    """What K1's CTAs compute: CTA c walks tiles c, c + grid, ...; a tile's
    codes are one contiguous, 16-byte aligned span of the flat int32 array,
    which layer 0 reads; each layer writes [rows, a_pad] tiles of the
    activation dtype and runs in groups of GROUP units (a unit past the
    layer's end repeats the last one and is not stored).  Returns the
    output codes."""
    act = {1: np.uint8, 2: np.uint16, 4: np.uint32}[lc.act_itemsize(layers)]
    flat = codes.numpy().reshape(-1)
    tab = tables.numpy().astype(np.int64)
    b, w0 = codes.shape
    out = np.full((b, layers[-1][1]), -1, np.int64)
    walked = []
    for cta in range(plan.grid):
        for tile in range(cta, plan.tiles, plan.grid):
            b0 = tile * plan.rows
            rows = min(plan.rows, b - b0)
            assert b0 * w0 * 4 % 16 == 0
            h = flat[b0 * w0:(b0 + rows) * w0].reshape(rows, w0)
            for l, (_, units, entries, off, fan, bits, asm) in enumerate(
                    layers):
                hn = np.zeros((rows, plan.a_pad), act)
                for k0 in range(0, units, lc.GROUP):
                    ks = np.arange(k0, k0 + lc.GROUP)
                    kk = np.minimum(ks, units - 1)
                    src = (kk[:, None] * fan + np.arange(fan) if asm
                           else maps[l].numpy()[kk])
                    a = np.zeros((rows, lc.GROUP), np.int64)
                    for f in range(fan):
                        a = (a << bits) + h[:, src[:, f]].astype(np.int64)
                    val = tab[off + kk, np.minimum(a, entries - 1)]
                    ok = ks < units
                    if l == len(layers) - 1:
                        out[b0:b0 + rows, ks[ok]] = val[:, ok]
                    else:
                        hn[:, k0:k0 + lc.GROUP] = np.where(ok, val, 0)
                h = hn
            walked.append(tile)
    assert sorted(walked) == list(range(plan.tiles))
    return torch.from_numpy(out.astype(np.int32))


@pytest.mark.parametrize("task,batch,rows,ctas,sms", [
    ("nid", 1, None, None, 132), ("nid", 3, None, None, 132),
    ("nid", 37, None, None, 132), ("nid", 37, 4, 1, 2),
    ("jsc_openml", 1, None, None, 132), ("jsc_openml", 3, None, None, 132),
    ("jsc_openml", 37, None, None, 132), ("jsc_openml", 37, 8, 1, 1),
])
def test_resident_emulation_equals_plain_bit_for_bit(task, batch, rows, ctas,
                                                     sms):
    """Ragged batches, and grids smaller than the tile count (persistent
    CTAs walking several tiles)."""
    layers = _layers(task)
    tables, maps = _random_cascade(layers, seed=batch)
    tables = tables.to(torch.int8 if task == "nid" else torch.int16)
    plan = lc.plan_resident(layers, tables.element_size(), batch, sms,
                            rows=rows, ctas_per_sm=ctas)
    if ctas is not None:
        assert plan.grid < plan.tiles
    codes = torch.from_numpy(np.random.RandomState(batch).randint(
        0, 2 ** layers[0][5], (batch, layers[0][0])).astype(np.int32))
    want = lc.lut_cascade_plain(codes, tables, maps, layers)
    assert torch.equal(_emulate_resident(codes, tables, maps, layers, plan),
                       want)


def test_resident_emulation_equals_reference_resident_kernel():
    """nid_reduced's fused plan, 4-row tiles on 3 CTAs, against the
    reference's resident Pallas kernel."""
    cfg = jtasks.task_config("nid_reduced")
    rs = np.random.RandomState(5)
    tables, maps = [], []
    for l, spec in enumerate(cfg.layers):
        entries = 2 ** (cfg.in_bits(l) * spec.fan_in)
        tables.append(rs.randint(0, 2 ** spec.bits, (spec.units, entries)
                                 ).astype(np.int32))
        maps.append(None if spec.assemble else rs.randint(
            0, cfg.prev_width(l), (spec.units, spec.fan_in)).astype(np.int32))
    jnet = jpipeline.CompiledLUTNetwork(cfg, tables, maps, -1.0, -1.0)
    plan = jnet.compile_backend("fused").plan
    layers = tuple(tuple(int(v) for v in l) for l in plan.meta["layers"])
    codes = rs.randint(0, 2 ** layers[0][5], (33, layers[0][0])
                       ).astype(np.int32)
    want = np.asarray(lut_cascade_pallas(
        jnp.asarray(codes), jnp.asarray(plan.buffers["amat"]),
        jnp.asarray(plan.buffers["tables"]), layers=layers, block_b=16,
        mode="resident", interpret=True))
    tmaps = [torch.from_numpy(plan.buffers[f"map_{l}"])
             if f"map_{l}" in plan.buffers else None
             for l in range(len(layers))]
    tab = torch.from_numpy(plan.buffers["tables"])
    rplan = lc.plan_resident(layers, tab.element_size(), 33, 3, rows=4,
                             ctas_per_sm=1)
    assert (rplan.grid, rplan.tiles) == (3, 9)
    got = _emulate_resident(torch.from_numpy(codes), tab, tmaps, layers,
                            rplan)
    np.testing.assert_array_equal(got.numpy(), want)
