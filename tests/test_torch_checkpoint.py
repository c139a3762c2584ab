"""The port's checkpoint manager (repro_torch.checkpoint) on the CPU: a
counterpart of each case of tests/test_checkpoint.py (atomic rename-aside
promotion, stranded-aside recovery, meta.json / shard validation raising
SnapshotIntegrityError), the tree flatten it rests on (core.types), the
async CheckpointManager, and the on-disk format against the JAX package's:
the same file names and meta keys, ``leaf_crc32`` and ``list_steps`` equal
to the reference's on the same arrays and directory states, and each
package's shard bytes readable by the other's checks.
"""
import json
import os
import shutil
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager,
    SnapshotIntegrityError,
    leaf_crc32,
    list_steps,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint.manager import load_arrays  # noqa: E402
from repro_torch.core.types import tree_flatten, tree_unflatten  # noqa: E402
from repro_torch.planning import PlanState, plan_state_template  # noqa: E402


def _tree(v=0.0):
    return {"w": torch.arange(6.0).reshape(2, 3) + v,
            "b": torch.zeros((3,), dtype=torch.float32),
            "step": torch.tensor(3, dtype=torch.int32)}


def _load(d, tree_like, step=None):
    return load_checkpoint(d, tree_like, step, device="cpu")


class TestAtomicPromotion:
    def test_overwrite_same_step_keeps_newest(self, tmp_path):
        d = str(tmp_path)
        save_checkpoint(d, 1, _tree(0.0))
        save_checkpoint(d, 1, _tree(5.0))      # exercises rename-aside
        out, step = _load(d, _tree())
        assert step == 1
        assert torch.equal(out["w"], _tree(5.0)["w"])
        assert not any(n.endswith(".aside") for n in os.listdir(d))

    def test_crash_between_renames_is_recovered(self, tmp_path):
        # Dying after `final -> aside` but before `tmp -> final`: the only
        # copy lives under the aside name; the next reader renames it back.
        d = str(tmp_path)
        final = save_checkpoint(d, 2, _tree(1.0))
        os.rename(final, final + ".aside")
        assert not os.path.exists(final)
        out, step = _load(d, _tree())    # triggers _recover
        assert step == 2
        assert torch.equal(out["w"], _tree(1.0)["w"])

    def test_superseded_aside_is_discarded(self, tmp_path):
        # Crash after `tmp -> final` but before deleting the aside: the final
        # is the new copy; recovery drops the stale aside.
        d = str(tmp_path)
        final = save_checkpoint(d, 3, _tree(2.0))
        shutil.copytree(final, final + ".aside")
        assert list_steps(d) == [3]
        assert not os.path.exists(final + ".aside")
        out, _ = _load(d, _tree())
        assert torch.equal(out["w"], _tree(2.0)["w"])

    def test_partial_names_never_parse_as_steps(self, tmp_path):
        d = str(tmp_path)
        save_checkpoint(d, 1, _tree())
        os.makedirs(os.path.join(d, "tmp.9.0"))       # stranded tmp dir
        (tmp_path / "step_12").mkdir()                # not 8 digits
        (tmp_path / "step_00000002x").mkdir()         # trailing junk
        assert list_steps(d) == [1]


class TestValidation:
    def test_structure_mismatch(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, _tree())
        with pytest.raises(SnapshotIntegrityError, match="leaves|treedef"):
            _load(str(tmp_path), {"w": torch.zeros((2, 3))})

    def test_treedef_mismatch_with_equal_leaf_count(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, _tree())
        other = {"w": torch.zeros(2, 3), "b": torch.zeros(3), "x": torch.tensor(3, dtype=torch.int32)}
        with pytest.raises(SnapshotIntegrityError, match="treedef"):
            _load(str(tmp_path), other)

    def test_dtype_mismatch(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, _tree())
        bad = _tree()
        bad["b"] = torch.zeros((3,), dtype=torch.int32)
        with pytest.raises(SnapshotIntegrityError, match="leaf"):
            _load(str(tmp_path), bad)

    def test_shape_mismatch(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, _tree())
        bad = _tree()
        bad["w"] = torch.zeros((3, 2))
        with pytest.raises(SnapshotIntegrityError, match="leaf"):
            _load(str(tmp_path), bad)

    def test_truncated_shard(self, tmp_path):
        final = save_checkpoint(str(tmp_path), 1, _tree())
        shard = os.path.join(final, "shard_0.npz")
        with open(shard, "rb") as f:
            data = f.read()
        with open(shard, "wb") as f:
            f.write(data[: len(data) // 2])
        with pytest.raises(SnapshotIntegrityError):
            _load(str(tmp_path), _tree())

    def test_meta_crc_mismatch(self, tmp_path):
        final = save_checkpoint(str(tmp_path), 1, _tree())
        mpath = os.path.join(final, "meta.json")
        with open(mpath) as f:
            meta = json.load(f)
        meta["crc32s"][0] ^= 1
        with open(mpath, "w") as f:
            json.dump(meta, f)
        with pytest.raises(SnapshotIntegrityError, match="CRC"):
            _load(str(tmp_path), _tree())

    def test_missing_meta(self, tmp_path):
        final = save_checkpoint(str(tmp_path), 1, _tree())
        os.remove(os.path.join(final, "meta.json"))
        with pytest.raises(SnapshotIntegrityError, match="meta.json"):
            _load(str(tmp_path), _tree())

    def test_leaf_crc_is_content_only(self):
        a = np.arange(6, dtype=np.float32).reshape(2, 3)
        assert leaf_crc32(a) == leaf_crc32(np.asfortranarray(a))
        b = a.copy()
        b[0, 0] += 1
        assert leaf_crc32(a) != leaf_crc32(b)

    def test_no_checkpoints(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            _load(str(tmp_path), _tree())


# -- the tree flatten -------------------------------------------------------------
class _Pair(NamedTuple):
    a: object
    epoch: int


def _mixed():
    """Every node and leaf kind a serving state is made of."""
    return {"pair": _Pair(a=torch.arange(4, dtype=torch.int32), epoch=12),
            "z": (torch.ones(2, 3, dtype=torch.complex64) * (1 - 2j), None),
            "lst": [torch.tensor(True), 5],
            "ps": plan_state_template(5, 2, 3, 4, warm=False, device="cpu")}


def test_flatten_round_trip_and_structure_string():
    tree = _mixed()
    leaves, td = tree_flatten(tree)
    assert td.num_leaves == len(leaves)
    assert td.leaf_kinds()[:4] == ["tensor", "int", "tensor", "int"]
    s = str(td)
    # readable and stable: dict keys sorted, type and field names, None marked
    assert s.startswith("{'lst': [*, int], 'pair': _Pair(a=*, epoch=int), ")
    assert "PlanState(plan=SplitPlan(s=*," in s and "warm_rho=None)" in s
    assert "'z': (*, None)" in s
    back = tree_unflatten(td, leaves)
    leaves2, td2 = tree_flatten(back)
    assert td2 == td and str(td2) == s
    assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y and type(x) is type(y)
               for x, y in zip(leaves, leaves2))
    assert isinstance(back["ps"], PlanState) and back["pair"].epoch == 12


@pytest.mark.parametrize("leaf", [object(), 1.5, True], ids=["object", "float", "bool"])
def test_flatten_refuses_unknown_leaves(leaf):
    """Only tensors, ints and None are leaves: a bool is not stored as an
    int, and a float would not round-trip as one."""
    with pytest.raises(TypeError, match="unsupported"):
        tree_flatten({"a": leaf})


def test_checkpoint_round_trip_of_mixed_tree(tmp_path):
    """Complex leaves, Python ints and None survive the npz round trip and
    their CRCs; ints come back as Python ints."""
    tree = _mixed()
    final = save_checkpoint(str(tmp_path), 7, tree)
    with open(os.path.join(final, "meta.json")) as f:
        meta = json.load(f)
    # keys sorted: lst (bool tensor, int), pair (int32 tensor, int), ps, z
    assert meta["dtypes"][:4] == ["bool", "int64", "int32", "int64"]
    assert meta["dtypes"][-1] == "complex64" and meta["shapes"][3] == []
    out, step = _load(str(tmp_path), _mixed())
    assert step == 7
    a, _ = tree_flatten(tree)
    b, _ = tree_flatten(out)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y
    assert out["z"][1] is None and out["pair"].epoch == 12


def test_manager_async_keep_n_and_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    live = _tree()
    for step in (1, 2, 3):
        mgr.save_async(step, {**live, "w": live["w"] + step})
        live["w"].add_(100.0)       # in-place updates after save never reach the write
    mgr.wait()
    assert list_steps(str(tmp_path)) == [2, 3] and mgr.latest_step() == 3
    out, step = mgr.restore(_tree(), device="cpu")
    assert step == 3
    assert torch.equal(out["w"], torch.arange(6.0).reshape(2, 3) + 200.0 + 3)
    out, _ = mgr.restore(_tree(), device="cpu", step=2)
    assert torch.equal(out["w"], torch.arange(6.0).reshape(2, 3) + 100.0 + 2)


def test_manager_surfaces_write_errors(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(str(blocker))
    mgr.save_async(1, _tree())
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                       # the error is raised once


# -- the on-disk format against the JAX package's ------------------------------------------
@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import repro.checkpoint as rc
    return rc


ARRAYS = [np.arange(6, dtype=np.float32).reshape(2, 3), np.zeros((3,), np.int32),
          np.asarray(3, np.int64), np.array([True, False]),
          (np.arange(8, dtype=np.float32) - 3j).astype(np.complex64).reshape(2, 4),
          np.asfortranarray(np.arange(12, dtype=np.float32).reshape(3, 4))]


@pytest.mark.parametrize("i", range(len(ARRAYS)))
def test_leaf_crc32_equals_the_references(ref, i):
    assert leaf_crc32(ARRAYS[i]) == ref.leaf_crc32(ARRAYS[i])


@pytest.mark.parametrize("state", ["plain", "aside_only", "aside_superseded", "junk_names",
                                   "missing_dir"])
def test_list_steps_equals_the_references(ref, tmp_path, state):
    """The same directory states give the same steps in both packages, and
    leave the same names behind (their recovery is the same)."""
    dirs = [str(tmp_path / "a"), str(tmp_path / "b")]
    for d in dirs:
        if state == "missing_dir":
            continue
        for step in (1, 4, 2):
            save_checkpoint(d, step, _tree(step))
        final = os.path.join(d, "step_00000004")
        if state == "aside_only":
            os.rename(final, final + ".aside")
        elif state == "aside_superseded":
            shutil.copytree(final, final + ".aside")
        elif state == "junk_names":
            os.makedirs(os.path.join(d, "tmp.9.0"))
            os.makedirs(os.path.join(d, "step_12"))
            os.makedirs(os.path.join(d, "step_00000003x"))
    assert list_steps(dirs[0]) == ref.list_steps(dirs[1])
    if state != "missing_dir":
        assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1]))


def test_on_disk_format_reads_across_packages(ref, tmp_path):
    """Both packages write step_<8 digits>/shard_0.npz + meta.json with the
    same keys, dtypes, shapes and CRCs for the same values, and each one's
    shard passes the other's byte checks."""
    import jax.numpy as jnp
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    port = save_checkpoint(port_dir, 5, _tree(1.0))
    jtree = {"w": jnp.arange(6.0).reshape(2, 3) + 1.0, "b": jnp.zeros((3,), jnp.float32),
             "step": jnp.asarray(3, jnp.int32)}
    theirs = ref.save_checkpoint(ref_dir, 5, jtree)
    assert os.path.basename(port) == os.path.basename(theirs) == "step_00000005"
    assert sorted(os.listdir(port)) == sorted(os.listdir(theirs)) == ["meta.json", "shard_0.npz"]
    metas = []
    for path in (port, theirs):
        with open(os.path.join(path, "meta.json")) as f:
            metas.append(json.load(f))
    assert set(metas[0]) == set(metas[1])
    for key in ("step", "n_leaves", "dtypes", "shapes", "crc32s"):
        assert metas[0][key] == metas[1][key], key
    # the port's reader checks the reference's bytes, and the reference's
    # reader the port's
    got = load_arrays(theirs, "shard_0.npz", metas[1])
    want = ref.manager._load_arrays(port, metas[0])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
