"""The port's checkpoint manager against the JAX package's, on the CPU.

* Format: the same train state in both packages (the reduced smollm-360m,
  the JAX package's parameters carried across with ``from_numpy_tree``,
  both packages' ``init_train_state``) gives ``META.json`` files with the
  same structure and, on every leaf but ``rng`` (a PRNG key in JAX, the
  ``torch.Generator``'s state in the port), the same file name, shape,
  dtype name and crc32. The port's ``restore`` reads a JAX-written
  checkpoint's leaves bit for bit.
* Faults: each case of ``tests/test_selfheal.py``'s checkpoint tests (a
  bit flip, a truncated leaf, a missing META.json, a missing leaf;
  mid-write and mid-rename artifacts; the fall-back restore; an async
  write failure attributed to its step) run through both managers gives
  the same exceptions, warnings, steps and values.
* What a torch state adds: the snapshot is a copy (changing the state
  after ``save_async`` leaves the checkpoint's bytes as they were), a
  ``torch.Generator`` comes back with its state, bf16 and fp8 tensors are
  stored as their raw bits under the JAX dtype name with the crc of the
  bytes JAX writes for the same values.
"""
from __future__ import annotations

import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import TrainConfig as JTrain
from repro.models import build as jax_build
from repro.models.params import init_params as jax_init_params
from repro.train import FaultPlan as JPlan
from repro.train import FaultSpec as JSpec
from repro.train import init_train_state as jax_init_state
from repro.train import make_train_setup as jax_setup
from repro.train.faults import FaultyCheckpointManager as JFaulty
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _crc32, _flatten_with_paths
from repro_torch.configs.base import TrainConfig
from repro_torch.models.params import from_numpy_tree, tree_paths
from repro_torch.train import FaultPlan, FaultSpec, init_train_state, make_train_setup
from repro_torch.train.faults import FaultyCheckpointManager

torch.set_num_threads(1)


def _states():
    """The reduced smollm-360m's train state in both packages, from the
    same parameters."""
    jp = jax_init_params(jax_build(jax_reduced("smollm-360m")).param_specs,
                         jax.random.PRNGKey(0))
    jopt, jscaler = jax_setup(JTrain())
    opt, scaler = make_train_setup(TrainConfig())
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    return jax_init_state(jp, jopt, jscaler), init_train_state(tp, opt, scaler)


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8).tobytes()


def _meta(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}", "META.json")) as f:
        return json.load(f)


def test_meta_matches_jax_on_every_leaf_but_rng(tmp_path):
    jstate, tstate = _states()
    JManager(str(tmp_path / "j")).save(0, jstate)
    CheckpointManager(str(tmp_path / "t")).save(0, tstate)
    jm, tm = _meta(tmp_path / "j", 0), _meta(tmp_path / "t", 0)
    assert tm["structure"] == jm["structure"] and tm["step"] == jm["step"] == 0
    assert set(tm["leaves"]) == set(jm["leaves"])
    assert len(jm["leaves"]) > 20
    for path, info in jm["leaves"].items():
        if path == "rng":
            assert tm["leaves"][path]["dtype"] == "uint8"       # the generator's state
            continue
        assert tm["leaves"][path] == info, path


def test_port_restores_a_jax_checkpoint_bit_for_bit(tmp_path):
    jstate, tstate = _states()
    JManager(str(tmp_path)).save(4, jstate, extra={"note": "jax"})
    mgr = CheckpointManager(str(tmp_path))
    tree, step, extra = mgr.restore()
    assert step == 4 and extra == {"note": "jax"}
    want = dict(_flatten_with_paths(jax.tree.map(np.asarray, jstate)))
    got = dict(_flatten_with_paths(tree))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and _bits(got[k]) == _bits(w), k
    # onto a port state: every tensor leaf in its dtype on the device
    like = tstate._replace(rng=torch.zeros(2, dtype=torch.int64))
    placed, _, _ = mgr.restore(4, like=like, device="cpu")
    assert type(placed).__name__ == "TrainState"
    for (k, t), (_, w) in zip(tree_paths(placed.params), tree_paths(jstate.params)):
        assert torch.equal(t, torch.from_numpy(np.array(w))), k


def _tree():
    return {"a": np.arange(24, dtype=np.float32).reshape(4, 6),
            "b": np.ones(7, dtype=np.float64)}


def _outcome(fn):
    """(result or None, exception type name or None, warning messages)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            out, err = fn(), None
        except Exception as e:                       # noqa: BLE001 - compared below
            out, err = None, type(e).__name__
    return out, err, [str(w.message).split(":")[0] for w in caught]


def _both(tmp_path, body):
    """``body(manager_cls, faulty_cls, plan, spec, directory)`` through both
    packages: the same outcomes, step by step."""
    got = {}
    for tag, mgr, faulty, plan, spec in (("jax", JManager, JFaulty, JPlan, JSpec),
                                         ("port", CheckpointManager, FaultyCheckpointManager,
                                          FaultPlan, FaultSpec)):
        got[tag] = body(mgr, faulty, plan, spec, tmp_path / tag)
    assert got["port"] == got["jax"]
    return got["port"]


def _arrays(tree):
    return None if tree is None else {k: np.asarray(v).tolist() for k, v in tree.items()}


@pytest.mark.parametrize("corruption", ["bitflip", "truncate", "truncate_header",
                                        "no_meta", "missing_leaf"])
def test_corruption_matches_jax(tmp_path, corruption):
    def body(Manager, Faulty, Plan, Spec, d):
        m = Manager(str(d), keep_last=3)
        m.save(2, _tree())
        leaf = d / "step_00000002"
        if corruption == "bitflip":
            data = bytearray((leaf / "a.npy").read_bytes())
            data[-1] ^= 0xFF
            (leaf / "a.npy").write_bytes(bytes(data))
        elif corruption.startswith("truncate"):
            with open(leaf / "a.npy", "r+b") as f:
                f.truncate(180 if corruption == "truncate" else 40)
        elif corruption == "no_meta":
            os.remove(leaf / "META.json")
        else:
            os.remove(leaf / "b.npy")
        return (m.all_steps(), _outcome(lambda: m.verify(2)),
                _outcome(lambda: m.restore(2, like=_tree()) and None),
                _outcome(lambda: m.restore() and None), m.valid_steps())
    steps, verify, strict, fallback, valid = _both(tmp_path, body)
    assert valid == []
    if corruption != "no_meta":
        assert verify[1] == strict[1] == "CheckpointCorruption"


def test_mid_rename_artifacts_match_jax(tmp_path):
    def body(Manager, Faulty, Plan, Spec, d):
        m = Manager(str(d), keep_last=5)
        m.save(2, _tree())
        os.makedirs(d / "step_00000004.tmp")
        os.makedirs(d / "step_00000006")
        tree, step, _ = m.restore(like=_tree())
        return m.all_steps(), m.latest_step(), step, _arrays(tree)
    assert _both(tmp_path, body)[:3] == ([2], 2, 2)


def test_fall_back_restore_matches_jax(tmp_path):
    def body(Manager, Faulty, Plan, Spec, d):
        m = Manager(str(d), keep_last=5)
        for s in (2, 4, 6):
            m.save(s, {"a": np.full((3, 3), float(s)), "b": np.ones(4)})
        with open(d / "step_00000006" / "a.npy", "r+b") as f:
            f.truncate(30)
        out = _outcome(lambda: m.restore(like=_tree()))
        tree, step, _ = out[0]
        return _arrays(tree), step, out[2], m.valid_steps()
    tree, step, warned, valid = _both(tmp_path, body)
    assert step == 4 and warned == ["skipping corrupt checkpoint"] and valid == [2, 4]
    assert tree["a"] == np.full((3, 3), 4.0).tolist()


def test_rotation_matches_jax(tmp_path):
    def body(Manager, Faulty, Plan, Spec, d):
        m = Manager(str(d), keep_last=2)
        for s in (1, 3, 5, 7):
            m.save_async(s, _tree())
        m.wait()
        return m.all_steps(), sorted(os.listdir(d))
    assert _both(tmp_path, body)[0] == [5, 7]


def test_async_failure_attributed_like_jax(tmp_path):
    def body(Manager, Faulty, Plan, Spec, d):
        m = Faulty(str(d), keep_last=3, plan=Plan([Spec(step=4, kind="fail_save", key="step")]))
        m.save_async(4, _tree())
        m._thread.join()
        err = _outcome(m.poll_error)
        step = None
        try:
            m.poll_error()
        except Exception as e:                       # noqa: BLE001 - one raise only
            step = e
        m.save(6, _tree())
        return err[1], step, m.valid_steps(), m.plan.fired_counts()
    err, again, valid, fired = _both(tmp_path, body)
    assert err == "CheckpointWriteError" and again is None and valid == [6]


def test_write_error_names_its_step(tmp_path):
    m = FaultyCheckpointManager(str(tmp_path), plan=FaultPlan(
        [FaultSpec(step=4, kind="fail_save", key="step")]))
    m.save_async(4, {"a": torch.ones(3)})
    with pytest.raises(Exception) as ei:
        m.wait()
    assert type(ei.value).__name__ == "CheckpointWriteError" and ei.value.step == 4
    assert isinstance(ei.value.__cause__, IOError)


def test_snapshot_is_a_copy(tmp_path):
    """Changing the state right after ``save_async`` (in place, as a next
    step could) leaves the checkpoint as it was at the call."""
    x = torch.arange(1 << 20, dtype=torch.float32)
    want = x.clone()
    m = CheckpointManager(str(tmp_path))
    m.save_async(1, {"x": x, "n": torch.tensor(3, dtype=torch.int32)})
    x.mul_(-1.0)
    m.wait()
    tree, _, _ = m.restore(1)
    assert np.array_equal(tree["x"], want.numpy()) and tree["n"] == 3


def test_generator_and_raw_bit_leaves_round_trip(tmp_path):
    gen = torch.Generator().manual_seed(7)
    torch.rand(5, generator=gen)
    vals = np.random.default_rng(3).standard_normal(64).astype(np.float32)
    jax_bits = {name: np.array(jnp.asarray(vals).astype(jdt)) for name, jdt in
                (("bf16", jnp.bfloat16), ("e4m3", jnp.float8_e4m3fn), ("e5m2", jnp.float8_e5m2))}
    state = {"bf16": torch.from_numpy(jax_bits["bf16"].view(np.int16)).view(torch.bfloat16),
             "e4m3": torch.from_numpy(jax_bits["e4m3"].view(np.uint8)).view(torch.float8_e4m3fn),
             "e5m2": torch.from_numpy(jax_bits["e5m2"].view(np.uint8)).view(torch.float8_e5m2),
             "rng": gen, "step": torch.tensor(5, dtype=torch.int32)}
    m = CheckpointManager(str(tmp_path))
    m.save(5, state)
    meta = _meta(tmp_path, 5)["leaves"]
    # the JAX dtype name, the crc of the bytes JAX writes for these values
    for name, jarr in jax_bits.items():
        assert meta[name]["dtype"] == str(jarr.dtype)
        assert meta[name]["crc32"] == _crc32(jarr) == zlib.crc32(jarr.tobytes())
    m.verify(5)
    like = dict(state, rng=torch.Generator())
    back, step, _ = m.restore(like=like, device="cpu")
    assert step == 5 and isinstance(back["rng"], torch.Generator)
    assert torch.equal(back["rng"].get_state(), gen.get_state())
    assert torch.equal(torch.rand(3, generator=back["rng"]), torch.rand(3, generator=gen))
    for name in ("bf16", "e4m3", "e5m2", "step"):
        assert back[name].dtype == state[name].dtype
        assert back[name].reshape(-1).view(torch.uint8).numpy().tobytes() == \
            state[name].reshape(-1).view(torch.uint8).numpy().tobytes(), name
