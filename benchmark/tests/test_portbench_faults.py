"""A run with the timed path broken underneath comes out not correct, once
for each fault the cells can have; the same run unbroken comes out correct.
The cells' entries drive the program on the CPU at a tiny size, under the
limits of the real cells; the harness's look for a card is skipped."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark import compare
from benchmark.entries import infer
from benchmark.tests import tiny


def run(mix_name: str, cell_factory=None, trace: bool = False) -> dict:
    real = harness.find_cell(next(c for c in tiny.cell_names() if c.endswith(mix_name)))
    spec = tiny.spec(mix_name, real.limits)
    return harness.run_cell(spec, 2 ** 31 + 17, 0.3, trace, "cpu", time.perf_counter(),
                            cell_factory=cell_factory)


@pytest.mark.parametrize("mix_name", ["infer_b64", "deit_b256"])
def test_sound_run_is_correct(mix_name):
    res = run(mix_name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


class AlteredAnswer(infer.Cell):
    """One answer of the window altered where it is produced: a logit of
    one row of the third request."""

    def request(self, i, out):
        d = super().request(i, out)
        if out is self.answers and len(out) == 3:
            k, logits = out[-1]
            logits = logits.clone()
            logits[0, 0] += 0.5 * logits[0].norm()
            out[-1] = (k, logits)
        return d


class HalfServed(infer.Cell):
    """Half of each batch left out: the model serves the first half only."""

    def request(self, i, out):
        d = super().request(i, out)
        k, logits = out[-1]
        out[-1] = (k, logits[: logits.shape[0] // 2])
        return d


@pytest.mark.parametrize("fault", [AlteredAnswer, HalfServed])
def test_inference_faults_are_caught(fault):
    res = run("infer_b64", fault)
    assert not res["correct"]
    assert res["failed"] >= 1


def test_unchanged_state_is_caught(monkeypatch):
    from octic_vits_tpu_torch.train.deit import engine

    real = engine.make_deit_train_step

    def frozen(model, cfg, optimizer, **kw):
        step = real(model, cfg, optimizer, **kw)

        def no_update(state, images, labels, generator):
            saved = {n: p.detach().clone() for n, p in model.named_parameters()}
            state, metrics = step(state, images, labels, generator)
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(saved[n])
            optimizer.state.clear()
            return state, metrics

        return no_update

    monkeypatch.setattr(engine, "make_deit_train_step", frozen)
    res = run("deit_b256")
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_unchanged_ema_is_caught(monkeypatch):
    from octic_vits_tpu_torch.train.deit import engine

    real = engine.make_deit_train_step

    def frozen_ema(model, cfg, optimizer, **kw):
        step = real(model, cfg, optimizer, **kw)

        def no_ema(state, images, labels, generator):
            saved = {n: t.clone() for n, t in state.ema.items()}
            state, metrics = step(state, images, labels, generator)
            for n, t in state.ema.items():
                t.copy_(saved[n])
            return state, metrics

        return no_ema

    monkeypatch.setattr(engine, "make_deit_train_step", frozen_ema)
    res = run("deit_b256")
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] < res["checks"]["change_gap"]["limit"]
    assert res["checks"]["ema_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_is_caught(monkeypatch):
    from octic_vits_tpu_torch.train.deit import engine

    real = engine.make_deit_train_step

    def halved(model, cfg, optimizer, **kw):
        step = real(model, cfg, optimizer, **kw)

        def half(state, images, labels, generator):
            b = images.shape[0] // 2
            return step(state, images[:b], labels[:b], generator)

        return half

    monkeypatch.setattr(engine, "make_deit_train_step", halved)
    res = run("deit_b256")
    assert not res["correct"]


def test_grad_of_unmoved_optimizer_reads_as_missing():
    got = {"losses": [1.0], "grad": {"a": 0.0, "b": 2.0}, "change": {"a": 0.0, "b": 0.0}}
    ref = {"losses": [1.0], "grad": {"a": 1.0, "b": 2.0}, "change": {"a": 1.0, "b": 1.0}}
    gaps = compare.train_gaps(got, ref)
    # leaf a: |0 - 1| over the median leaf's 1.5
    assert gaps["grad_gap"] == pytest.approx(1 / 1.5) and gaps["change_gap"] == 1.0


def test_ssl_sound_run_is_correct():
    res = run("ssl_b256")
    assert res["correct"], res["checks"]


def test_ssl_unchanged_state_is_caught(monkeypatch):
    from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import SSLMetaArch

    real = SSLMetaArch.make_train_step

    def frozen(self):
        step = real(self)

        def no_update(state, batch, sched, generator=None):
            saved = {n: p.detach().clone() for n, p in state.student.named_parameters()}
            state, metrics = step(state, batch, sched, generator)
            with torch.no_grad():
                for n, p in state.student.named_parameters():
                    p.copy_(saved[n])
                for t in list(state.mu.values()) + list(state.nu.values()):
                    t.zero_()
            return state, metrics

        return no_update

    monkeypatch.setattr(SSLMetaArch, "make_train_step", frozen)
    res = run("ssl_b256")
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_ssl_half_batch_is_caught(monkeypatch):
    from octic_vits_tpu_torch.train.dinov2.ssl_meta_arch import SSLMetaArch

    from benchmark.entries.ssl_step import halve

    real = SSLMetaArch.make_train_step

    def halved(self):
        step = real(self)

        def half(state, batch, sched, generator=None):
            return step(state, halve(batch, self.cfg.n_local_crops), sched, generator)

        return half

    monkeypatch.setattr(SSLMetaArch, "make_train_step", halved)
    res = run("ssl_b256")
    assert not res["correct"]
