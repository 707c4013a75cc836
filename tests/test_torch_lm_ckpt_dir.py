"""``launch.train.run_lm``'s checkpoint directory: without ``--ckpt-dir``
the run checkpoints into a temporary directory, printed when the run
starts and removed when it ends, on success and on error; a directory
the caller names is kept.  llama3.2-3b at smoke size on the CPU, 3 steps
of 2 x 16 tokens, ``tempfile.tempdir`` pointed at the test's own
directory."""
from __future__ import annotations

import tempfile

import pytest

from repro_torch.launch.train import build_parser, run_lm
from repro_torch.train import trainer
from repro_torch.train.checkpoint import CheckpointManager


def _args(steps=3, *more):
    return build_parser().parse_args(
        ["--arch", "llama3.2-3b", "--smoke", "--device", "cpu", "--steps",
         str(steps), "--batch", "2", "--seq", "16", "--workers", "1",
         *more])


def test_run_lm_removes_its_temporary_checkpoints(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = run_lm(_args())
    assert out["report"].checkpoints > 0
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("[ckpt] ")]
    assert len(printed) == 1 and str(tmp_path / "ckpt_") in printed[0]
    assert not list(tmp_path.glob("ckpt_*"))


def _fail_after_two_steps(monkeypatch):
    """Every train step after the second raises; returns the list the
    steps append to."""
    made = trainer.make_train_step
    calls = []

    def failing(*a, **kw):
        step, opt = made(*a, **kw)

        def step_fn(*args):
            calls.append(1)
            if len(calls) > 2:          # after the step-2 checkpoint
                raise RuntimeError("injected")
            return step(*args)
        return step_fn, opt
    monkeypatch.setattr(trainer, "make_train_step", failing)
    return calls


def test_run_lm_removes_them_on_error(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    _fail_after_two_steps(monkeypatch)
    # 6 steps: a checkpoint at step 2, then a failure on every step until
    # the supervisor's 3 restarts are spent (one batch each)
    with pytest.raises(RuntimeError, match="injected"):
        run_lm(_args(6))
    assert not list(tmp_path.glob("ckpt_*"))


def test_run_lm_raises_the_steps_error_when_the_writer_fails_too(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    calls = _fail_after_two_steps(monkeypatch)
    wait = CheckpointManager.wait

    def broken_wait(self):
        if len(calls) >= 6:             # the last failure: restarts spent
            raise OSError("writer")
        return wait(self)
    monkeypatch.setattr(CheckpointManager, "wait", broken_wait)
    with pytest.raises(RuntimeError, match="injected"):
        run_lm(_args(6))
    assert "OSError('writer')" in capsys.readouterr().err
    assert not list(tmp_path.glob("ckpt_*"))


def test_run_lm_keeps_the_callers_directory(tmp_path):
    mine = tmp_path / "mine"
    out = run_lm(_args(3, "--ckpt-dir", str(mine)))
    assert out["report"].checkpoints > 0
    assert list(mine.glob("step_*"))
