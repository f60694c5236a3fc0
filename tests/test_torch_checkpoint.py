"""The port's checkpoint bundles (``repro_torch.checkpoint.Checkpointer``):
torch and numpy leaves of a store's carry round-trip exactly (dtypes,
devices, None leaves, named tuples), the newest of many steps is listed,
and a bundle that was corrupted, truncated, tampered with, or restored into
a changed template is refused — the guarantees the JAX package's
``tests/test_checkpoint.py`` states for its own format."""

import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.sync import AlgoCarry
from repro_torch.sync.simulator import Chunk


def state(seed=0):
    g = torch.Generator().manual_seed(seed)
    carry = AlgoCarry(
        x=torch.randint(0, 9, (3, 4, 8), generator=g, dtype=torch.int32),
        buf=torch.randint(0, 2, (5, 3, 4, 8), generator=g).bool(),
        buf_elems=torch.randint(0, 9, (3, 4), generator=g,
                                dtype=torch.int32),
        aux=None)
    ys = Chunk(tuple(np.arange(6, dtype=np.int64).reshape(2, 3) + i
                     for i in range(4)), np.ones((2, 3), bool))
    return {"carry": carry, "ys": ys, "tuple": (torch.ones(2), None)}


def assert_equal_state(a, b):
    for f in AlgoCarry._fields:
        x, y = getattr(a["carry"], f), getattr(b["carry"], f)
        if x is None:
            assert y is None
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), f
    for x, y in zip(a["ys"].metrics, b["ys"].metrics):
        assert isinstance(y, np.ndarray) and y.dtype == x.dtype
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a["ys"].uniform, b["ys"].uniform)
    assert torch.equal(a["tuple"][0], b["tuple"][0]) and b["tuple"][1] is None


def test_roundtrip_mixed_leaves(tmp_path):
    ck = Checkpointer(tmp_path / "ck")
    s = state()
    digest = ck.save(4, s, extra={"chunk_rounds": 4})
    assert ck.manifest(4)["digest"] == digest
    assert ck.manifest(4)["extra"] == {"chunk_rounds": 4}
    out = ck.restore(4, state(1))
    assert isinstance(out["carry"], AlgoCarry) and isinstance(out["ys"], Chunk)
    assert_equal_state(s, out)


def test_available_steps_and_latest_of_many(tmp_path):
    ck = Checkpointer(tmp_path)
    for step in (12, 4, 8):
        ck.save(step, state(step))
    assert ck.available_steps() == [4, 8, 12]
    assert_equal_state(state(12), ck.restore(12, state()))
    (tmp_path / "step_00000099").mkdir()        # no manifest: not a step
    assert ck.available_steps() == [4, 8, 12]


def bundle(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, state())
    return ck, tmp_path / "step_00000001"


def test_restore_refuses_a_bitflip(tmp_path):
    ck, path = bundle(tmp_path)
    data = torch.load(path / "tensors.pt", weights_only=True)
    data["a0"][0, 0, 0] += 1
    torch.save(data, path / "tensors.pt")
    with pytest.raises(ValueError, match="digest"):
        ck.restore(1, state())


def test_restore_refuses_truncation(tmp_path):
    ck, path = bundle(tmp_path)
    raw = (path / "tensors.pt").read_bytes()
    (path / "tensors.pt").write_bytes(raw[: len(raw) // 2])
    with pytest.raises(ValueError, match="unreadable or truncated"):
        ck.restore(1, state())


def test_restore_refuses_a_tampered_manifest(tmp_path):
    ck, path = bundle(tmp_path)
    man = json.loads((path / "manifest.json").read_text())
    man["digest"] = "0" * 16
    (path / "manifest.json").write_text(json.dumps(man))
    with pytest.raises(ValueError, match="digest"):
        ck.restore(1, state())


def test_restore_refuses_a_renamed_leaf(tmp_path):
    ck, _ = bundle(tmp_path)
    like = state()
    like["carriage"] = like.pop("carry")
    with pytest.raises(ValueError, match="reordered or renamed"):
        ck.restore(1, like)


def test_restore_refuses_a_leaf_count_mismatch(tmp_path):
    ck, _ = bundle(tmp_path)
    like = state()
    like["extra"] = torch.zeros(1)
    with pytest.raises(ValueError, match="tree structure changed"):
        ck.restore(1, like)


def test_restore_refuses_a_shape_mismatch(tmp_path):
    ck, _ = bundle(tmp_path)
    like = state()
    like["carry"] = like["carry"]._replace(x=torch.zeros((3, 4, 9),
                                                         dtype=torch.int32))
    with pytest.raises(ValueError, match="restore template expects"):
        ck.restore(1, like)
