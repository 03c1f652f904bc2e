"""The port's data pipeline, checkpoints and straggler watchdog against
the JAX package's, on the CPU:

* `SyntheticLMData.batch(step)` equals the reference's bit for bit
  (tokens and `src_embeds`) over several steps and seeds;
* the counterparts of `tests/test_train_loop.py`'s
  `test_checkpoint_atomic_and_metadata`, `test_elastic_reshard_roundtrip`
  (restore with `device=`) and `test_straggler_watchdog`;
* the layout is the reference's: each package restores the other's
  checkpoint of the same tree; bf16 leaves round-trip bit for bit;
* `CheckpointManager` keeps the newest `keep` steps, saves a snapshot
  taken when it was asked (the optimizer updates in place), and leaves
  no temporary directory behind.
"""
import os
from collections import OrderedDict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.data import SyntheticLMData as JData
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    read_metadata, restore, save)
from repro_torch.data import SyntheticLMData
from repro_torch.launch.train import StragglerWatchdog


@pytest.mark.parametrize("seed,src_len", [(0, 0), (3, 8)])
def test_synthetic_batches_equal_the_reference(seed, src_len):
    kw = dict(seed=seed, src_len=src_len, d_model=16)
    ref = JData(300, 40, 5, **kw)
    port = SyntheticLMData(300, 40, 5, device="cpu", **kw)
    for step in (0, 1, 7, 123):
        want, got = ref.batch(step), port.batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].device.type == "cpu"
            assert got[k].numpy().dtype == w.dtype
            np.testing.assert_array_equal(got[k].numpy(), w)


def test_checkpoint_atomic_and_metadata(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4), "b": torch.zeros(3)}
    p = save(str(tmp_path), 7, tree, metadata={"arch": "x"})
    assert os.path.isdir(p)
    assert sorted(os.listdir(tmp_path)) == ["step_00000007"]
    meta = read_metadata(str(tmp_path), 7)
    assert meta["step"] == 7 and meta["metadata"]["arch"] == "x"
    assert meta["keys"] == ["['b']", "['w']"]
    back = restore(str(tmp_path), 7, tree)
    assert torch.equal(back["w"], tree["w"])


def test_elastic_restore_onto_a_device(tmp_path):
    """A checkpoint restores onto the device asked for, with each leaf's
    saved dtype: the one-card elastic path."""
    tree = {"w": torch.arange(64.0).reshape(8, 8),
            "opt": OrderedDict(m=torch.linspace(-3, 3, 10).bfloat16(),
                               n=[torch.ones(2, dtype=torch.int32)])}
    save(str(tmp_path), 1, tree)
    back = restore(str(tmp_path), 1, tree, device=torch.device("cpu"))
    assert isinstance(back["opt"], OrderedDict)
    assert back["opt"]["m"].dtype == torch.bfloat16
    assert torch.equal(back["opt"]["m"].view(torch.int16),
                       tree["opt"]["m"].view(torch.int16))
    assert torch.equal(back["w"], tree["w"])
    assert torch.equal(back["opt"]["n"][0], tree["opt"]["n"][0])
    meta = restore(str(tmp_path), 1, tree, device="meta")
    assert meta["w"].device.type == "meta" and meta["w"].shape == (8, 8)


def test_each_package_restores_the_others_checkpoint(tmp_path):
    tree = {"a": np.arange(6.0, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.ones(4, np.float32)}}
    save(str(tmp_path / "port"), 2, {k: (torch.tensor(v) if k == "a" else
                                         {"c": torch.tensor(v["c"])})
                                     for k, v in tree.items()})
    jback = jrestore(str(tmp_path / "port"), 2,
                     {"a": jnp.zeros((2, 3)), "b": {"c": jnp.zeros(4)}})
    np.testing.assert_array_equal(np.asarray(jback["a"]), tree["a"])
    np.testing.assert_array_equal(np.asarray(jback["b"]["c"]),
                                  tree["b"]["c"])
    jsave(str(tmp_path / "ref"), 3, {k: (jnp.asarray(v) if k == "a" else
                                         {"c": jnp.asarray(v["c"])})
                                     for k, v in tree.items()})
    back = restore(str(tmp_path / "ref"), 3, tree)
    np.testing.assert_array_equal(back["a"].numpy(), tree["a"])
    np.testing.assert_array_equal(back["b"]["c"].numpy(), tree["b"]["c"])


def test_straggler_watchdog():
    dog = StragglerWatchdog(factor=3.0)
    for i in range(20):
        dog.observe(i, 0.1)
    assert not dog.events
    assert dog.observe(20, 1.0)   # 10x median -> flagged
    assert dog.events[0]["step"] == 20


@pytest.mark.parametrize("async_save", [True, False])
def test_manager_keeps_the_newest_and_snapshots(tmp_path, async_save):
    mgr = CheckpointManager(str(tmp_path), every=2, keep=2,
                            async_save=async_save)
    w = torch.zeros(3)
    saved = []
    for step in range(1, 10):
        w += 1.0                                  # an in-place update
        if mgr.maybe_save(step, {"w": w}, metadata={"step": step}):
            saved.append(step)
    mgr.wait()
    assert saved == [2, 4, 6, 8]
    assert sorted(os.listdir(tmp_path)) == ["step_00000006",
                                            "step_00000008"]
    assert latest_step(str(tmp_path)) == 8
    for step in (6, 8):
        back = restore(str(tmp_path), step, {"w": w})
        assert torch.equal(back["w"], torch.full((3,), float(step)))
    assert mgr.maybe_save(9, {"w": w}, force=True)
    mgr.wait()
    assert latest_step(str(tmp_path)) == 9
    assert len(os.listdir(tmp_path)) == 2
