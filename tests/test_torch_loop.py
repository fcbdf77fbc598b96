"""The port's production loop (``repro_torch.train.loop``) on the CPU: it
survives injected failures (the reference's
``test_train_loop_survives_injected_failures``), resumes from the newest
complete step, and a failed step replayed from a checkpoint gives the bits
of an uninterrupted run; the training CLI end to end."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.ckpt import checkpoint
from repro_torch.configs import lm_archs
from repro_torch.launch import steps, train
from repro_torch.train import loop as train_loop, optim


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_loop_survives_injected_failures(tmp_path):
    """A step that fails twice mid-run completes with checkpoint-restore
    replay and reaches the target step (the reference test on the port's
    tensors and in-place AdamW)."""
    params = {"w": torch.zeros(2)}
    opt = optim.adamw_init([params["w"]])
    fail_at = {"steps": {3, 4}}

    def step_fn(p, o, batch):
        if batch["step"] in fail_at["steps"]:
            fail_at["steps"].discard(batch["step"])
            raise RuntimeError("boom")
        o, _ = optim.adamw_update(optim.AdamWConfig(lr=0.1), [p["w"]],
                                  [torch.ones(2) * 0.1], o)
        return p, o, {"loss": torch.sum(p["w"] ** 2)}

    state = train_loop.LoopState(params=params, opt_state=opt)
    cfg = train_loop.LoopConfig(total_steps=6, ckpt_dir=str(tmp_path),
                                ckpt_every=2, ckpt_async=False,
                                max_retries=2)
    state = train_loop.run(cfg, state, step_fn, lambda s: {"step": s})
    assert state.step == 6
    assert state.failures == 2
    assert checkpoint.latest_step(str(tmp_path)) == 6
    # the failure at step 3 restored step 2's checkpoint: step 2 ran twice
    assert [set(m) for m in state.metrics_history] == [
        {"loss", "step_time_s", "straggler"}] * 7
    # retries are bounded: a step that always fails raises
    state = train_loop.LoopState(params={"w": torch.zeros(2)},
                                 opt_state=optim.adamw_init([torch.zeros(2)]))

    def broken(p, o, batch):
        raise RuntimeError("device lost")
    with pytest.raises(RuntimeError, match="device lost"):
        train_loop.run(dataclasses.replace(cfg, ckpt_dir=None), state,
                       broken, lambda s: {"step": s})
    assert state.failures == 3


def _lm_run(tmp_path, total, *, fail_at=(), ckpt_every=2, ckpt_async=True):
    """mixtral's smoke config trained ``total`` steps through the loop
    (checkpoints every ``ckpt_every``), raising once at each step of
    ``fail_at`` before the step's update."""
    cfg = lm_archs.smoke("mixtral-8x22b")
    params = steps.init_fn(cfg)(torch.Generator().manual_seed(0), "cpu")
    step = steps.make_train_step(cfg, opt_cfg=optim.AdamWConfig(
        lr=3e-3, weight_decay=0.1, schedule=optim.cosine_schedule(8, 2)))
    pending = set(fail_at)

    def step_fn(p, o, batch):
        if int(batch["step"]) in pending:
            pending.discard(int(batch["step"]))
            raise RuntimeError("preempted")
        return step(p, o, batch)

    def batch_fn(s):
        toks = np.random.RandomState(s).randint(0, cfg.vocab, (2, 13))
        return dict(steps.batch_on({"tokens": toks[:, :-1],
                                    "labels": toks[:, 1:]}, "cpu"),
                    step=s)
    state = train_loop.LoopState(params=params,
                                 opt_state=steps.opt_init(params),
                                 codec=steps.StateCodec())
    lcfg = train_loop.LoopConfig(total_steps=total, ckpt_dir=str(tmp_path),
                                 ckpt_every=ckpt_every, ckpt_async=ckpt_async)
    return train_loop.run(lcfg, state, step_fn, batch_fn)


def _same(a, b):
    for x, y in zip(steps.train_leaves(a.params) + a.opt_state.m
                    + a.opt_state.v, steps.train_leaves(b.params)
                    + b.opt_state.m + b.opt_state.v):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert a.opt_state.step == b.opt_state.step


def test_lm_replay_and_resume_are_bit_exact(tmp_path, one_thread):
    """A failure at step 5 restores step 4's checkpoint and replays; the
    final parameters, moments and losses equal an uninterrupted run's bit
    for bit.  A second run on the same directory resumes from the newest
    complete step (a stale ``.tmp`` ignored) and only finishes the
    remaining steps."""
    clean = _lm_run(tmp_path / "clean", 6)
    failed = _lm_run(tmp_path / "failed", 6, fail_at=(5,))
    assert failed.failures == 1 and failed.step == clean.step == 6
    _same(clean, failed)
    assert [m["loss"] for m in failed.metrics_history][-1] == \
        clean.metrics_history[-1]["loss"]
    # resume: a 4-step run, then the same directory to 8 steps
    (tmp_path / "resume" / "step_0000000099.tmp").mkdir(parents=True)
    part = _lm_run(tmp_path / "resume", 4, ckpt_async=False)
    assert checkpoint.latest_step(str(tmp_path / "resume")) == 4
    done = _lm_run(tmp_path / "resume", 8, ckpt_async=False)
    assert len(part.metrics_history) == 4 and len(done.metrics_history) == 4
    full = _lm_run(tmp_path / "full", 8)
    _same(full, done)


def test_train_cli_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on the CPU: trains the smoke
    config through the loop, checkpoints the last step in the reference's
    format, resumes from it, and refuses a mesh it cannot run."""
    argv = ["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--steps",
            "3", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(tmp_path)]
    state = train.main(argv)
    assert state.step == 3 and len(state.metrics_history) == 3
    assert checkpoint.latest_step(str(tmp_path)) == 3
    assert "3 steps on cpu" in capsys.readouterr().out
    again = train.main(argv)
    assert again.step == 3 and again.metrics_history == []
    # a (2, 1) mesh needs two ranks; this process is one
    with pytest.raises(SystemExit, match="WORLD_SIZE"):
        train.main(argv + ["--mesh", "2,1"])
    assert not torch.distributed.is_initialized()
    wstate = train.main(["--arch", "whisper-small", "--smoke", "--device",
                         "cpu", "--steps", "2", "--batch", "2", "--seq",
                         "8"])
    assert np.isfinite(wstate.metrics_history[-1]["loss"])
