"""The LM serving engine and sampling of the port on the CPU: the
reference's engine tests mirrored on the port, and the port's engine and
sampler held against the JAX package's on the same weights and seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_archs as jarchs
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve import sampling as jsampling
from repro_torch.configs import lm_archs
from repro_torch.models import lm
from repro_torch.serve import sampling
from repro_torch.serve.engine import Request, ServeEngine


@pytest.fixture(scope="module")
def engine_setup():
    """gemma-2b smoke in f32, weights drawn by JAX and carried across."""
    jcfg = dataclasses.replace(jarchs.smoke("gemma-2b"), dtype="float32",
                               remat=False)
    cfg = dataclasses.replace(lm_archs.smoke("gemma-2b"), dtype="float32",
                              remat=False)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    params = lm.params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                      "cpu")
    return cfg, params, jcfg, jparams


def _req(rid, seed, n=6, max_tokens=5, cls=Request):
    g = np.random.default_rng(seed)
    return cls(rid=rid, prompt=g.integers(0, 100, n).astype(np.int32),
               max_tokens=max_tokens)


def test_engine_completes_requests(engine_setup):
    cfg, params, _, _ = engine_setup
    eng = ServeEngine(cfg, params, slots=2, context=32, device="cpu")
    done = eng.run([_req(i, i) for i in range(5)])
    assert len(done) == 5
    for r in done:
        assert len(r.out_tokens) == r.max_tokens
        assert all(0 <= t < cfg.vocab for t in r.out_tokens)
    # continuous batching reused slots (5 requests > 2 slots)
    assert eng.stats.prefills == 5
    assert eng.stats.decode_steps >= 4
    assert len(eng.stats.prefill_ms) == 5
    assert len(eng.stats.decode_ms) == eng.stats.decode_steps


def test_engine_greedy_matches_manual_decode(engine_setup):
    """Engine output for one request == a manual prefill + decode chain."""
    cfg, params, _, _ = engine_setup
    prompt = np.arange(4, dtype=np.int32) + 3
    eng = ServeEngine(cfg, params, slots=1, context=32, device="cpu")
    got = eng.run([Request(rid=0, prompt=prompt, max_tokens=4)])[0].out_tokens
    logits, cache = lm.prefill(params, cfg, torch.from_numpy(prompt)[None],
                               32)
    want = [int(torch.argmax(logits[0, :cfg.vocab]))]
    for _ in range(3):
        logits, cache = lm.decode_step(
            params, cfg, cache, torch.tensor([[want[-1]]], dtype=torch.int32))
        want.append(int(torch.argmax(logits[0, :cfg.vocab])))
    assert got == want


def test_engine_mixed_prompt_lengths_match_solo(engine_setup):
    """Requests with different prompt lengths share one decode batch and
    still give their solo greedy decodes (per-slot positions)."""
    cfg, params, _, _ = engine_setup
    p1 = np.arange(4, dtype=np.int32) + 3
    p2 = np.arange(9, dtype=np.int32) + 1
    want = {}
    for rid, prompt in [(0, p1), (1, p2)]:
        eng = ServeEngine(cfg, params, slots=1, context=32, device="cpu")
        done = eng.run([Request(rid=rid, prompt=prompt, max_tokens=5)])
        want[rid] = done[0].out_tokens
    eng = ServeEngine(cfg, params, slots=2, context=32, device="cpu")
    done = eng.run([Request(rid=0, prompt=p1, max_tokens=5),
                    Request(rid=1, prompt=p2, max_tokens=5)])
    assert {r.rid: r.out_tokens for r in done} == want


def test_engine_eos_frees_slot(engine_setup):
    cfg, params, _, _ = engine_setup
    eng = ServeEngine(cfg, params, slots=1, context=32, device="cpu")
    prompt = np.arange(4, dtype=np.int32)
    r = Request(rid=0, prompt=prompt, max_tokens=10, eos_id=None)
    eng.submit(r)
    eng.tick()
    r2 = Request(rid=1, prompt=prompt, max_tokens=2)
    while not r.done:
        eng.tick()
    assert eng.free == [0]
    assert eng.submit(r2)
    # an EOS equal to the next greedy token ends a request after one tick
    eos = ServeEngine(cfg, params, slots=1, context=32, device="cpu")
    probe = eos.run([Request(rid=2, prompt=prompt, max_tokens=2)])[0]
    eos = ServeEngine(cfg, params, slots=1, context=32, device="cpu")
    r3 = Request(rid=3, prompt=prompt, max_tokens=10,
                 eos_id=probe.out_tokens[1])
    assert eos.run([r3])[0].out_tokens == probe.out_tokens
    assert eos.free == [0]


def test_port_and_reference_engines_give_the_same_greedy_tokens(
        engine_setup):
    """slots 2, context 32, 5 requests of mixed lengths (one reaches past
    the ring length during decode)."""
    cfg, params, jcfg, jparams = engine_setup
    lengths = (6, 3, 11, 1, 25)
    reqs = [_req(i, 10 + i, n=n, max_tokens=9) for i, n in enumerate(lengths)]
    jreqs = [_req(i, 10 + i, n=n, max_tokens=9, cls=jengine.Request)
             for i, n in enumerate(lengths)]
    got = ServeEngine(cfg, params, slots=2, context=32, device="cpu").run(
        reqs)
    want = jengine.ServeEngine(jcfg, jparams, slots=2, context=32).run(jreqs)
    assert [(r.rid, r.out_tokens) for r in got] == \
        [(r.rid, r.out_tokens) for r in want]


@pytest.mark.parametrize("params", [
    dict(), dict(temperature=0.7), dict(temperature=1.3, top_k=5),
    dict(temperature=0.9, top_p=0.8), dict(temperature=0.8, top_k=50,
                                           top_p=0.9)])
def test_sample_np_matches_reference(params):
    logits = np.random.RandomState(5).normal(size=(40, 128)).astype(
        np.float32) * 3
    got_rng, want_rng = np.random.default_rng(7), np.random.default_rng(7)
    got = [sampling.sample_np(l, sampling.SamplingParams(**params), got_rng)
           for l in logits]
    want = [jsampling.sample_np(l, jsampling.SamplingParams(**params),
                                want_rng) for l in logits]
    assert got == want


def test_sample_torch_greedy_and_support():
    """Greedy is the argmax (as the reference's sample_jax); sampling draws
    only from the top-k / top-p set the reference's device sampler keeps."""
    logits = torch.from_numpy(np.random.RandomState(6).normal(
        size=(64, 100)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    greedy = sampling.sample_torch(logits, sampling.SamplingParams(), gen)
    want = jsampling.sample_jax(jnp.asarray(logits.numpy()),
                                jsampling.SamplingParams(),
                                jax.random.PRNGKey(0))
    assert greedy.tolist() == np.asarray(want).tolist()
    top5 = torch.topk(logits, 5, dim=-1).indices
    for _ in range(4):
        tok = sampling.sample_torch(
            logits, sampling.SamplingParams(temperature=1.0, top_k=5), gen)
        assert bool((top5 == tok[:, None]).any(-1).all())
    probs = torch.softmax(logits, -1)
    order = torch.sort(probs, -1, descending=True)
    keep = torch.cumsum(order.values, -1) - order.values < 0.5
    for _ in range(4):
        tok = sampling.sample_torch(
            logits, sampling.SamplingParams(temperature=1.0, top_p=0.5), gen)
        rank = (order.indices == tok[:, None]).float().argmax(-1)
        assert bool(keep.gather(1, rank[:, None]).all())
