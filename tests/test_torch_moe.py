"""The port's MoE layer (``repro_torch.models.moe``) on the CPU, held
against ``repro.models.moe`` with weights carried across and inputs from
numpy seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe

# f32: the packages sum in other orders; observed <= 4e-7
F32_TOL = dict(rtol=2e-4, atol=2e-4)
# bf16: XLA's CPU keeps bf16 chains in f32 where PyTorch rounds each op;
# observed 2 ulps (0.016) on outputs of magnitude 1.5
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


_japply = jax.jit(jmoe.apply_moe, static_argnums=(1, 3))


def _layer(e, k, cf, gated=True, act="silu", seed=1):
    jspec = jmoe.MoESpec(16, 32, e, k, act=act, gated=gated,
                         capacity_factor=cf)
    spec = moe.MoESpec(16, 32, e, k, act=act, gated=gated,
                       capacity_factor=cf)
    jp = jax.tree.map(lambda a: a[0], jmoe.init_moe(jax.random.PRNGKey(seed),
                                                    jspec, 1))
    p = moe.MoE(spec)
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(jp[name])))
    return jspec, spec, jp, p


def _x(b, s, seed=0):
    return np.random.RandomState(seed).normal(size=(b, s, 16)).astype(
        np.float32)


@pytest.mark.parametrize("s", [1, 7, 64, 300])
@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (16, 4)])
def test_capacity_matches_reference(e, k, s):
    for cf in (0.5, 1.0, 1.25, 64.0):
        assert moe.capacity(moe.MoESpec(16, 32, e, k, capacity_factor=cf),
                            s) == jmoe.capacity(
            jmoe.MoESpec(16, 32, e, k, capacity_factor=cf), s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,k,cf,s,gated", [
    (4, 2, 1.25, 20, True),     # mixtral-like smoke routing
    (16, 4, 1.0, 33, True),     # dbrx's top-4 of 16
    (8, 2, 64.0, 5, True),      # no drops (the decode-vs-prefill setting)
    (4, 2, 0.5, 40, False),     # heavy dropping, plain relu2 experts
    (8, 2, 1.25, 1, True)])     # one token: a decode step
def test_apply_moe_matches_reference(e, k, cf, s, gated, dtype):
    jspec, spec, jp, p = _layer(e, k, cf, gated=gated,
                                act="silu" if gated else "relu2")
    x = _x(3, s)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jx = jnp.asarray(x, jdt)
    jy, jaux = _japply(jp, jspec, jx)
    y, aux = moe.apply_moe(p, spec, torch.from_numpy(np.array(
        jx.astype(jnp.float32))).to(tdt))
    assert y.shape == (3, s, 16) and y.dtype == tdt
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy, np.float32), **tol)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_dropped_tokens_are_neither_dispatched_nor_combined():
    """capacity 8 for 40 tokens x 2 routings on 4 experts: tokens beyond an
    expert's 8 slots get no contribution from it; the same tokens routed
    alone (one group each, never over capacity) get the full output."""
    _, spec, _, p = _layer(4, 2, 0.1, seed=2)
    x = torch.from_numpy(_x(1, 40, seed=3))
    assert moe.capacity(spec, 40) == 8
    y, _ = moe.apply_moe(p, spec, x)
    alone = torch.cat([moe.apply_moe(p, spec, x[:, t:t + 1])[0]
                       for t in range(40)], dim=1)
    logits = (x @ p.router).float()
    _, idx = moe.top_k(logits, 2)
    onehot = torch.nn.functional.one_hot(idx.reshape(1, -1), 4)
    pos = ((onehot.cumsum(1) - 1) * onehot).sum(-1).reshape(1, 40, 2)
    kept = (pos < 8).all(-1)[0]
    assert 0 < int(kept.sum()) < 40
    torch.testing.assert_close(y[0, kept], alone[0, kept], rtol=1e-5,
                               atol=1e-5)
    assert not torch.allclose(y[0, ~kept], alone[0, ~kept])
    assert torch.equal(y[0, (pos >= 8).all(-1)[0]],
                       torch.zeros_like(y[0, (pos >= 8).all(-1)[0]]))


def test_top_k_ties_pick_the_lower_expert_like_jax():
    rs = np.random.RandomState(4)
    logits = rs.randint(0, 3, size=(50, 8)).astype(np.float32)
    for k in (1, 2, 4):
        jv, ji = jax.lax.top_k(jnp.asarray(logits), k)
        tv, ti = moe.top_k(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("tied", [False, True])
def test_router_fn_hook_matches_reference(tied):
    """``router_fn`` replaces the dense router (the folded LUT router's
    hook); with integer-valued logits most tokens tie among the 8 experts,
    and routing, capacity and combine still equal the reference's."""
    jspec, spec, jp, p = _layer(8, 2, 1.0, seed=5)
    rs = np.random.RandomState(6)
    table = (rs.randint(0, 2, size=(16, 8)) if tied
             else rs.normal(size=(16, 8))).astype(np.float32)

    def jrouter(xf):
        return jnp.round(xf) @ jnp.asarray(table) if tied else \
            xf @ jnp.asarray(table)

    def router(xf):
        return torch.round(xf) @ torch.from_numpy(table) if tied else \
            xf @ torch.from_numpy(table)

    x = _x(2, 24, seed=7)
    jy, jaux = _japply(jp, jspec, jnp.asarray(x), jrouter)
    y, aux = moe.apply_moe(p, spec, torch.from_numpy(x), router_fn=router)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    if tied:
        lg = router(torch.from_numpy(x).reshape(48, 16))
        top = lg.sort(-1, descending=True).values
        assert bool((top[:, 1] == top[:, 2]).any())    # ties at the cut
    # the hook bypasses the dense router entirely
    with torch.no_grad():
        p.router.fill_(float("nan"))
    y2, _ = moe.apply_moe(p, spec, torch.from_numpy(x), router_fn=router)
    torch.testing.assert_close(y2, y, rtol=0, atol=0)


def test_init_moe_shapes_and_fan_in():
    spec = moe.MoESpec(32, 48, 4, 2)
    p = moe.init_moe(torch.Generator().manual_seed(0), spec)
    assert p.router.shape == (32, 4) and p.w_up.shape == (4, 32, 48)
    assert p.w_down.shape == (4, 48, 32) and p.w_gate.shape == (4, 32, 48)
    np.testing.assert_allclose(float(p.w_up.std()), 32 ** -0.5, rtol=0.05)
    np.testing.assert_allclose(float(p.w_down.std()), 48 ** -0.5, rtol=0.05)
    assert moe.MoE(moe.MoESpec(8, 8, 2, 1, gated=False)).w_gate is None
