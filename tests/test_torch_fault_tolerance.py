"""`repro_torch.runtime.fault_tolerance` against the reference's
(`repro.runtime.fault_tolerance`), on the host: the reference's own cases
(`tests/test_substrate.py`), the injector and the straggler tracker given
the same seeded step and time sequences, and the reference's supervision
loop driving the port's checkpointer.

Tolerance: none (traces, states and counts are equal).
"""

import threading

import numpy as np
import pytest
import torch

from repro.runtime import fault_tolerance as ref_ft
from repro_torch.checkpoint.checkpointer import Checkpointer, latest_step
from repro_torch.runtime.fault_tolerance import (
    FailureInjector, NodeFailure, StragglerMitigator, run_with_restarts,
)

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)


def _counting_loop(injector, ck, trace, total=12):
    def loop(state, start):
        x = state["x"]
        for step in range(start, total):
            injector.check(step)
            x = x + 1.0
            trace.append(step)
            ck.save(step, {"x": x})
        return {"x": x}
    return loop


# ------------------------------------------------- the reference's own cases
def test_failure_injection_and_restart(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    injector = FailureInjector(fail_at_steps=(7,), max_failures=1)
    trace = []
    state, restarts = run_with_restarts(lambda: {"x": torch.zeros(())},
                                        _counting_loop(injector, ck, trace), ck, 12)
    assert restarts == 1
    # Steps 0-6 ran, failure at 7, resumed from checkpoint 6 -> step 7..11.
    assert trace.count(7) == 1 and trace.count(6) == 1
    assert float(state["x"]) == 12.0


def test_restart_budget_exhausted(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    injector = FailureInjector(fail_at_steps=(0,), max_failures=100)

    def loop(state, start):
        injector.check(0)
        return state

    with pytest.raises(NodeFailure):
        run_with_restarts(lambda: {}, loop, ck, 1, max_restarts=2)


def test_straggler_detection():
    s = StragglerMitigator(factor=3.0)
    for step in range(10):
        assert not s.observe(step, 1.0)
    assert s.observe(10, 10.0)  # 10x median
    assert s.stragglers == [10]
    assert s.deadline() == pytest.approx(3.0)


# ------------------------------------------------------------ the reference
@pytest.mark.parametrize("kw", [dict(fail_at_steps=(3, 9), max_failures=1),
                                dict(fail_at_steps=(2,), probability=0.3, seed=4, max_failures=5),
                                dict(probability=0.5, seed=11, max_failures=3)])
def test_failure_injector_equals_the_references(kw):
    """The same steps fail, drawing from the same seeded NumPy stream."""
    port, ref = FailureInjector(**kw), ref_ft.FailureInjector(**kw)
    failed = {"port": [], "ref": []}
    for step in range(40):
        for name, inj, exc in (("port", port, NodeFailure), ("ref", ref, ref_ft.NodeFailure)):
            try:
                inj.check(step)
            except exc as e:
                failed[name].append((step, str(e)))
    assert failed["port"] == failed["ref"] and failed["port"]


@pytest.mark.parametrize("factor,window", [(3.0, 50), (1.5, 8)])
def test_straggler_mitigator_equals_the_references(factor, window):
    times = np.random.default_rng(2).lognormal(0.0, 0.6, 120)
    port = StragglerMitigator(factor=factor, window=window)
    ref = ref_ft.StragglerMitigator(factor=factor, window=window)
    for step, t in enumerate(times):
        assert port.observe(step, float(t)) == ref.observe(step, float(t))
        assert port.p50() == ref.p50() and port.deadline() == ref.deadline()
    assert port.stragglers == ref.stragglers and port.stragglers
    assert port.times == ref.times and len(port.times) == window


def test_reference_loop_drives_the_port_checkpointer(tmp_path):
    """The reference's `run_with_restarts` with the port's `Checkpointer`
    (synchronous, so the reference reads a settled directory) gives the
    port's trace, state and restart count (each loop fails through its
    own package's injector, whose `NodeFailure` its supervisor catches)."""
    runs = {}
    for name, supervise, injector in (
        ("ref", ref_ft.run_with_restarts, ref_ft.FailureInjector((5,), max_failures=2)),
        ("port", run_with_restarts, FailureInjector((5,), max_failures=2)),
    ):
        ck = Checkpointer(str(tmp_path / name), keep=2, async_save=False)
        trace = []

        def loop(state, start, trace=trace, ck=ck, injector=injector):
            w = state["w"]
            for step in range(start, 12):
                injector.check(step)
                w = w * 1.5 + step
                trace.append(step)
                if step % 3 == 0:
                    ck.save(step, {"w": w, "count": step})
            return {"w": w, "count": 11}

        state, restarts = supervise(lambda: {"w": torch.ones(3), "count": 0}, loop, ck, 12)
        runs[name] = (trace, state, restarts)
    (t_ref, s_ref, r_ref), (t_port, s_port, r_port) = runs["ref"], runs["port"]
    assert r_ref == r_port == 2
    # Step 5 fails twice (it fails again on its replay), each time back to
    # the save of step 3.
    assert t_ref == t_port == [0, 1, 2, 3, 4, 4, 4, 5, 6, 7, 8, 9, 10, 11]
    assert torch.equal(s_ref["w"], s_port["w"]) and s_ref["count"] == s_port["count"]


def test_failure_after_an_async_save_restores_that_save(tmp_path, monkeypatch):
    """A save at step 4 still being written when step 5 fails: the port
    waits for the write, so the restore point is step 4, not step 2."""
    release = threading.Event()
    savez = np.savez

    def late_savez(path, **arrays):
        if "step_4" in path:
            release.wait(10)  # the writer thread is slow on this save
        savez(path, **arrays)

    monkeypatch.setattr(np, "savez", late_savez)
    ck = Checkpointer(str(tmp_path), async_save=True)
    injector = FailureInjector(fail_at_steps=(5,), max_failures=1)
    trace = []

    def loop(state, start):
        x = state["x"]
        for step in range(start, 8):
            if step == 5 and not release.is_set():
                assert latest_step(str(tmp_path)) == 2  # step 4 not yet published
                threading.Timer(0.2, release.set).start()
            injector.check(step)
            x = x + 1.0
            trace.append(step)
            if step % 2 == 0:
                ck.save(step, {"x": x})
        return {"x": x}

    state, restarts = run_with_restarts(lambda: {"x": torch.zeros(())}, loop, ck, 8)
    ck.wait()
    assert restarts == 1
    assert trace == [0, 1, 2, 3, 4, 5, 6, 7]
    assert float(state["x"]) == 8.0
