"""`repro_torch.checkpoint.checkpointer` against the reference's
(`repro.checkpoint.checkpointer`), on the host: the reference's own
checkpoint cases (`tests/test_substrate.py`), keys equal to the
reference's ``_flatten``, and each package restoring the other's
checkpoints.

Tolerance: none.  A restore is bit for bit, across packages and across
devices (the card case is marked ``cuda`` and skips without one).
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro.checkpoint.checkpointer import _flatten as ref_flatten
from repro_torch.checkpoint.checkpointer import Checkpointer, flatten, latest_step

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)


def _state(seed=0):
    """A trainer-shaped tree: per-layer lists of dicts, f32 leaves, an int
    step count."""
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"layers": [{"attn": {"wq": torch.randn((4, 6), generator=g)},
                               "norm": torch.randn((6,), generator=g)} for _ in range(3)],
                   "embed": torch.randn((5, 6), generator=g)},
        "opt": {"m": [torch.randn((2,), generator=g)], "count": 7},
    }


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
        assert a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()
    else:
        assert a == b


# ------------------------------------------ the reference's checkpoint cases
def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"m": torch.ones(3), "count": 7}}
    ck.save(10, state)
    assert latest_step(str(tmp_path)) == 10
    restored = ck.restore(10, like=state)
    _same(restored, state)
    assert restored["opt"]["count"] == 7


def test_checkpoint_atomic_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    for step in [1, 2, 3, 4]:
        ck.save(step, {"x": torch.full((3,), float(step))})
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == [3, 4]
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    manifest = (tmp_path / "step_4" / "manifest.json").read_text()
    assert '"step": 4' in manifest and '"keys": ["x"]' in manifest
    os.makedirs(tmp_path / "step_9.tmp")  # a write cut short is not a step
    assert latest_step(str(tmp_path)) == 4
    assert latest_step(str(tmp_path / "absent")) is None


def test_checkpoint_async(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(5, {"x": torch.ones(8)})
    ck.wait()
    assert latest_step(str(tmp_path)) == 5
    assert len(ck.save_s) == len(ck.write_s) == 1


def test_checkpoint_reshard_restore(tmp_path):
    """The reference restores onto given shardings; the port onto a given
    device (``device=``), whatever the device of ``like``."""
    ck = Checkpointer(str(tmp_path), async_save=False)
    state = {"w": torch.arange(8.0)}
    ck.save(1, state)
    restored = ck.restore(1, like={"w": torch.zeros(8, device="meta")}, device="cpu")
    assert restored["w"].device == torch.device("cpu")
    _same(restored, state)


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, {"w": torch.ones(4)})
    with pytest.raises(ValueError):
        ck.restore(1, like={"w": torch.ones(5)})
    with pytest.raises(KeyError, match="missing keys"):
        ck.restore(1, like={"w": torch.ones(4), "b": torch.ones(1)})


# ------------------------------------------------------------ the reference
def test_keys_equal_the_references_flatten():
    rng = np.random.default_rng(0)
    tree = {"b": [rng.standard_normal(2), {"z": rng.standard_normal(1), "a": 3}],
            "a": {"10": np.zeros(1), "9": [np.ones(2), np.ones(3)]}, "count": 4}
    want, _ = ref_flatten(tree)
    got = flatten(tree)
    assert list(got) == list(want)
    assert "b/1/z" in got and "a/9/1" in got
    for k in got:
        assert got[k] is want[k]


def _jax_state(state):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()) if isinstance(t, torch.Tensor)
                        else jnp.asarray(t), state)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    state = _state(1)
    RefCheckpointer(str(tmp_path), async_save=False).save(3, _jax_state(state))
    like = _state(2)
    assert latest_step(str(tmp_path)) == 3
    _same(Checkpointer(str(tmp_path)).restore(3, like=like), state)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    state = _state(3)
    Checkpointer(str(tmp_path), async_save=False).save(4, state)
    ref = RefCheckpointer(str(tmp_path)).restore(4, like=_jax_state(_state(4)))
    want = _jax_state(state)
    got_leaves, want_leaves = jax.tree.leaves(ref), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves) == len(flatten(state))
    for a, b in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype and np.asarray(a).tobytes() == np.asarray(b).tobytes()


# ------------------------------------------------------------ the port's own
def test_async_snapshot_is_taken_before_save_returns(tmp_path, monkeypatch):
    """AdamW updates in place: an ``add_`` after `save` returns must not
    reach the checkpoint, however late the writer thread runs."""
    release = threading.Event()
    savez = np.savez

    def late_savez(*args, **kwargs):
        release.wait(10)
        savez(*args, **kwargs)

    monkeypatch.setattr(np, "savez", late_savez)
    ck = Checkpointer(str(tmp_path), async_save=True)
    w = torch.arange(6.0)
    want = w.clone()
    ck.save(1, {"w": w})
    w.add_(1.0)  # the next step, while the write is held
    release.set()
    ck.wait()
    _same(ck.restore(1, like={"w": w}), {"w": want})


def test_int_count_comes_back_as_int(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(2, {"opt": {"count": 12, "m": torch.zeros(2)}})
    got = ck.restore(2, like={"opt": {"count": 0, "m": torch.ones(2)}})
    assert type(got["opt"]["count"]) is int and got["opt"]["count"] == 12


def test_bf16_leaf_raises_naming_the_key(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    with pytest.raises(TypeError, match="params/w"):
        ck.save(1, {"params": {"w": torch.ones(3, dtype=torch.bfloat16)}})
    assert latest_step(str(tmp_path)) is None


def test_restore_casts_to_the_like_dtype(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, {"w": torch.tensor([1.5, -2.25])})
    got = ck.restore(1, like={"w": torch.zeros(2, dtype=torch.float64)})
    assert got["w"].dtype == torch.float64 and got["w"].tolist() == [1.5, -2.25]


@pytest.mark.cuda
def test_card_and_host_read_each_others_checkpoints(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    state = _state(5)
    on_card = {"params": {"layers": [], "embed": state["params"]["embed"].cuda()},
               "opt": {"m": [state["opt"]["m"][0].cuda()], "count": 7}}
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(1, on_card)
    on_card["params"]["embed"].add_(1.0)
    ck.wait()
    host = ck.restore(1, like={"params": {"layers": [], "embed": torch.zeros(5, 6)},
                               "opt": {"m": [torch.zeros(2)], "count": 0}})
    assert host["params"]["embed"].device.type == "cpu"
    assert host["params"]["embed"].numpy().tobytes() == state["params"]["embed"].numpy().tobytes()
    ck.save(2, host)
    ck.wait()
    back = ck.restore(2, like=on_card)
    assert back["params"]["embed"].device.type == "cuda"
    assert back["params"]["embed"].cpu().numpy().tobytes() == \
        state["params"]["embed"].numpy().tobytes()
    assert back["opt"]["count"] == 7
