"""GPipe (``repro_torch.dist.pipeline.make_pipelined_fn``) on 4 gloo
ranks, 4 stages x 2 layers, D 16, 6 microbatches, held against the plain
JAX scan of the reference's pipeline test at rtol/atol 2e-5, in
``M + S - 1`` ticks.  The JAX result is computed here; the ranks
(``torch_dist_worker.py``) never import JAX."""
import jax
import jax.numpy as jnp
import numpy as np

import torch_dist_worker


def _plain_scan(ws: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """The reference test's oracle: a scan over all layers a microbatch."""
    def layer_fn(w, x):
        return jnp.tanh(x @ w)

    def fwd(x):
        def body(h, w):
            return layer_fn(w, h), None
        h, _ = jax.lax.scan(body, x, jnp.asarray(ws))
        return h
    return np.asarray(jax.vmap(fwd)(jnp.asarray(xs)))


def test_gpipe_four_stages_matches_plain_scan(tmp_path):
    ws, xs = torch_dist_worker.gpipe_inputs()
    ref = _plain_scan(ws, xs)
    res = torch_dist_worker.spawn("gpipe", 4, tmp_path, timeout=120)
    n_micro, n_stages = xs.shape[0], 4
    for r in range(4):
        assert res[r]["ticks"] == n_micro + n_stages - 1
        np.testing.assert_allclose(res[r]["out"].numpy(), ref, rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_array_equal(res[r]["out"].numpy(),
                                      res[0]["out"].numpy())
