"""A whole run without the look for a chip, on the CPU at a small size,
with the timed path broken underneath: ``correct`` has to come out false
for each fault the cell can have, and true without one. A served answer
altered where it is produced; a training step that leaves its state
unchanged; a step on half of its batch; a step whose forward covers the
whole batch and whose loss covers half of it; a step that hands the
optimizer the gradient's negative. (The cells run on one chip, so no
exchange between chips can be left out.) Each fault is planted in the
program by patching it for the one run."""

import json
from pathlib import Path

import numpy as np
import pytest

from port_bench.run import result_line, run_cell

BENCH = json.loads((Path(__file__).resolve().parents[2]
                    / "BENCHMARK.json").read_text())
KIND = {w["name"]: ("serve" if "serve" in w["traffic"] else "train")
        for w in BENCH["workloads"]}
FAULTS = {"serve": ["answer"],
          "train": ["unchanged", "half_rows", "half_loss", "climb"]}
CASES = [(cell, fault) for cell, kind in sorted(KIND.items())
         for fault in [None] + FAULTS[kind]]


def halve(batch):
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


def plant(monkeypatch, fault):
    from lowlight_image_enhancement_tpu_torch import serving
    from lowlight_image_enhancement_tpu_torch.training import (
        train_step,
        trainer,
    )

    opt = train_step.ChainOptimizer
    if fault == "answer":
        predict = serving.RestorationServer.predict

        def altered(self, images, *a, **kw):
            outs = predict(self, images, *a, **kw)
            outs[0] = outs[0] + np.float32(0.01)
            return outs
        monkeypatch.setattr(serving.RestorationServer, "predict", altered)
    elif fault == "unchanged":
        monkeypatch.setattr(opt, "step", lambda self, grads: None)
    elif fault == "half_rows":
        make = trainer.make_train_step

        def make_half(*a, **kw):
            step = make(*a, **kw)
            return lambda state, batch: step(state, halve(batch))
        monkeypatch.setattr(trainer, "make_train_step", make_half)
    elif fault == "half_loss":
        kwargs = train_step.hybrid_batch_kwargs

        def half_kwargs(output, batch):
            n = output.shape[0] // 2
            return kwargs(output[:n], halve(batch))
        monkeypatch.setattr(train_step, "hybrid_batch_kwargs", half_kwargs)
    elif fault == "climb":
        step = opt.step
        monkeypatch.setattr(opt, "step", lambda self, grads: step(
            self, [-g for g in grads]))


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_correct_is_false_exactly_under_a_fault(small_cell, monkeypatch,
                                                 cell, fault):
    c = small_cell(cell)
    plant(monkeypatch, fault)
    run, attempted, failed, readings = run_cell(
        c, 3141592653, 2.0, False, "cpu")
    line = result_line(c, run, attempted, failed, False, readings, c.limits,
                       "cpu")
    assert attempted > 0 and list(line)[-1] == "checks"
    assert line["correct"] is (fault is None), line["checks"]
