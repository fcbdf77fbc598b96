"""K3's launch plan and its gather, on the CPU.

``lut_gather.tile_shape`` is plain Python: how many outputs a thread and
threads a CTA the barrier-free gather takes.  The kernel runs only on the
card; here a numpy emulation of what its threads do -- thread t owns the
flat outputs [t * vec, (t + 1) * vec) of [B, U], wrapping along U into the
next row, and clamps each address into the table -- is held against the
plain version, and the plain version against the reference's
``lut_lookup_pallas`` (interpret mode) at nid's layer shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lut_gather import lut_lookup_pallas
from repro_torch.configs import paper_tasks
from repro_torch.kernels import lut_gather


@pytest.mark.parametrize("entries", [2, 64, 4096, 32768])
@pytest.mark.parametrize("units,batch,threads,grid", [
    (1, 1024, 32, 8), (60, 1024, 64, 240), (2160, 1024, 256, 2160),
    (60, 1, 32, 1), (2160, 4096, 256, 8640)])
def test_tile_shape(entries, units, batch, threads, grid):
    """Four outputs a thread; the largest CTA (32 to 256 threads, a power
    of two) that still gives each of 132 SMs a CTA; the same for every
    table width (no staged route)."""
    plan = lut_gather.tile_shape(entries, units, batch, 132)
    assert (plan.threads, plan.vec, plan.grid) == (threads, 4, grid)
    assert plan.grid * plan.threads * plan.vec >= units * batch
    assert (plan.grid - 1) * plan.threads * plan.vec < units * batch
    scalar = lut_gather.tile_shape(entries, units, batch, 132, False)
    assert scalar.vec == 1
    assert scalar.grid * scalar.threads >= units * batch


def test_tile_shape_covers_the_sms_at_nid():
    """nid's layers (U = 60, 20, 9, 3, 1 at a block of 1024 rows): the grid
    reaches every SM wherever there are 4 x 32 x 132 outputs to share."""
    for u in (60, 20, 9, 3, 1):
        plan = lut_gather.tile_shape(64, u, 1024, 132)
        n = u * 1024
        assert plan.grid >= min(132, -(-n // (4 * 32)))


def test_tile_shape_refuses():
    with pytest.raises(ValueError, match="outputs exceed"):
        lut_gather.tile_shape(64, 2 ** 16, 2 ** 16, 132)
    with pytest.raises(ValueError, match="table"):
        lut_gather.tile_shape(0, 4, 4, 132)


def _emulate(table, addr, plan):
    """What K3's threads write, thread by thread."""
    tab = table.numpy()
    flat = addr.numpy().reshape(-1)
    b, u = addr.shape
    n, t = b * u, tab.shape[1]
    out = np.full(n, -1, np.int64)
    for th in range(plan.grid * plan.threads):
        i0 = th * plan.vec
        if i0 >= n:
            continue
        unit = i0 % u
        for i in range(i0, min(i0 + plan.vec, n)):
            out[i] = tab[unit, min(max(flat[i], 0), t - 1)]
            unit = 0 if unit + 1 == u else unit + 1
    return torch.from_numpy(out.reshape(b, u).astype(np.int32))


@pytest.mark.parametrize("units,entries,batch,aligned", [
    (60, 64, 37, True), (9, 64, 5, True), (3, 64, 7, False), (1, 2, 3, True),
    (7, 4096, 6, True)])
def test_gather_emulation_equals_plain_with_clamped_addresses(
        units, entries, batch, aligned):
    rs = np.random.RandomState(units + batch)
    table = torch.from_numpy(rs.randint(0, 100, (units, entries)
                                        ).astype(np.int32))
    addr = torch.from_numpy(rs.randint(-3, entries + 3, (batch, units)
                                       ).astype(np.int32))
    plan = lut_gather.tile_shape(entries, units, batch, 4, aligned)
    want = lut_gather.lut_lookup_plain(table, addr.clamp(0, entries - 1))
    assert torch.equal(_emulate(table, addr, plan), want)


def test_plain_equals_reference_pallas_at_nid_layer_shapes():
    """nid's per-layer tables [U, 64] for U = 60, 20, 9, 3, 1 on a ragged
    batch, against the reference's one-hot Pallas kernel."""
    cfg = paper_tasks.task_config("nid")
    rs = np.random.RandomState(11)
    for l, spec in enumerate(cfg.layers):
        entries = 2 ** (cfg.in_bits(l) * spec.fan_in)
        table = rs.randint(0, 2 ** spec.bits, (spec.units, entries)
                           ).astype(np.int32)
        addr = rs.randint(0, entries, (37, spec.units)).astype(np.int32)
        want = np.asarray(lut_lookup_pallas(jnp.asarray(table),
                                            jnp.asarray(addr),
                                            interpret=True))
        got = lut_gather.lut_lookup(torch.from_numpy(table),
                                    torch.from_numpy(addr))
        np.testing.assert_array_equal(got.numpy(), want)
        plan = lut_gather.tile_shape(entries, spec.units, 37, 132)
        assert torch.equal(_emulate(torch.from_numpy(table),
                                    torch.from_numpy(addr), plan), got)
