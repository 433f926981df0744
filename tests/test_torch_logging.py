"""The port's MetricLogger with a stand-in ``wandb`` module.

A ``wandb.init`` that fails, and whose error reporter keeps the exception
(as wandb's does when it cannot log in), must not keep the frame that made
the logger alive: that frame holds a CLI's model and optimizer state.  An
init that starts gives the run the metrics.  No JAX here."""

import gc
import json
import sys
import types
import weakref

import pytest

from captionax_torch.train.logging import MetricLogger


class Big:
    """Stands in for a model: only its lifetime matters."""


def fake_wandb(fail: bool):
    mod = types.ModuleType("wandb")
    mod.kept = []  # the error reporter's hold on every failure
    mod.logged = []

    class Run:
        def log(self, metrics, step=None):
            mod.logged.append((dict(metrics), step))

        def finish(self):
            mod.logged.append("finished")

    def init(**kwargs):
        if fail:
            try:
                raise RuntimeError("no login")
            except RuntimeError as e:
                mod.kept.append(e)
                raise
        return Run()

    mod.init = init
    return mod


def make_logger(tmp_path):
    model = Big()
    logger = MetricLogger(str(tmp_path), "run")
    return weakref.ref(model), logger


def test_failed_wandb_init_keeps_no_caller_frame(tmp_path, monkeypatch):
    wandb = fake_wandb(fail=True)
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    gc.disable()
    try:
        model, logger = make_logger(tmp_path)
        assert model() is None  # freed with make_logger's frame, no collection needed
    finally:
        gc.enable()
    assert len(wandb.kept) == 1 and logger._wandb is None
    logger.log({"train_loss": 1.5}, 3)
    logger.close()
    with open(tmp_path / "run.jsonl") as f:
        row = json.loads(f.readline())
    assert row["step"] == 3 and row["train_loss"] == 1.5


@pytest.mark.parametrize("use_wandb", [True, False])
def test_wandb_run_gets_the_metrics(tmp_path, monkeypatch, use_wandb):
    wandb = fake_wandb(fail=False)
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    logger = MetricLogger(str(tmp_path), "run", use_wandb=use_wandb)
    logger.log({"train_loss": 2.0}, 1)
    logger.close()
    assert wandb.logged == ([({"train_loss": 2.0}, 1), "finished"] if use_wandb else [])
