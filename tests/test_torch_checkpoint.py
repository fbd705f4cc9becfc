"""The port's ``CheckpointManager`` (``repro_torch.training.checkpoint``):
round trips, the JAX package's on-disk layout in both directions, the
two-phase commit's crash cases, keep-last-K and async save.  Restored
values must be bit-equal to what was saved (``np.array_equal``)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.training import checkpoint as jckpt  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402


def _tree(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "latent": rng.standard_normal((8, 16)).astype(np.float32),
        "blocks": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                   "step": np.int32(seed)},
        "layers": [rng.standard_normal(5).astype(np.float64),
                   rng.integers(0, 9, (2, 2)).astype(np.int64)],
    }


def _leaves(tree) -> dict:
    return {k: np.asarray(v) for k, v in tckpt._paths(tree)}


def _assert_same(got, want):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        assert np.array_equal(g[k], w[k]), k


def test_round_trip_of_numpy_and_tensors(tmp_path):
    tree = _tree(1)
    tree["blocks"]["t"] = torch.arange(6, dtype=torch.float32).view(2, 3)
    mgr = tckpt.CheckpointManager(tmp_path)
    mgr.save(3, tree, extra={"sigma": 0.5})
    assert mgr.latest_step() == 3
    got, meta = mgr.restore(tree)
    assert meta["step"] == 3 and meta["extra"] == {"sigma": 0.5}
    assert isinstance(got["blocks"]["t"], torch.Tensor)
    assert torch.equal(got["blocks"]["t"], tree["blocks"]["t"])
    assert isinstance(got["layers"], list)
    _assert_same(got, tree)


def test_keys_follow_jax_tree_paths():
    """Dict keys sorted, list entries by index: jax.tree_util's order
    and the JAX package's ``a/b`` keys."""
    tree = _tree()
    assert list(tckpt._flatten(tree)) == list(jckpt._flatten(tree))


def test_port_restores_a_jax_snapshot(tmp_path):
    tree = _tree(2)
    jckpt.CheckpointManager(tmp_path).save(7, tree, extra={"req": "r0"})
    got, meta = tckpt.CheckpointManager(tmp_path).restore(_tree(9))
    assert meta == {"step": 7, "extra": {"req": "r0"},
                    "keys": sorted(tckpt._flatten(tree))}
    _assert_same(got, tree)


def test_jax_restores_a_port_snapshot(tmp_path):
    tree = _tree(3)
    tckpt.CheckpointManager(tmp_path).save(4, tree, extra={"req": "r1"})
    got, meta = jckpt.CheckpointManager(tmp_path).restore(_tree(9))
    assert meta["step"] == 4 and meta["extra"] == {"req": "r1"}
    _assert_same(got, tree)
    # the same files, byte for byte, as the JAX package writes
    jckpt.CheckpointManager(tmp_path / "jax").save(4, tree,
                                                   extra={"req": "r1"})
    for f in sorted((tmp_path / "jax" / "step_4").iterdir()):
        assert (tmp_path / "step_4" / f.name).read_bytes() == \
            f.read_bytes(), f.name


def test_stray_tmp_directory_is_ignored(tmp_path):
    """A crash mid-write leaves ``step_N.tmp``: it is no restore point."""
    mgr = tckpt.CheckpointManager(tmp_path)
    mgr.save(1, _tree(1))
    (tmp_path / "step_2.tmp").mkdir()
    (tmp_path / "step_2.tmp" / "latent.npy").write_bytes(b"torn")
    assert mgr.steps() == [1]
    assert mgr.latest_step() == 1
    got, meta = mgr.restore(_tree())
    assert meta["step"] == 1
    _assert_same(got, _tree(1))


def test_latest_naming_a_missing_step_falls_back(tmp_path):
    """A crash between the rename and ``LATEST``'s update (or a step
    removed since) falls back to the newest complete step."""
    mgr = tckpt.CheckpointManager(tmp_path, keep=5)
    mgr.save(1, _tree(1))
    mgr.save(2, _tree(2))
    (tmp_path / "LATEST").write_text("9")
    assert mgr.latest_step() == 2
    (tmp_path / "LATEST").unlink()
    assert mgr.latest_step() == 2
    got, _ = mgr.restore(_tree())
    _assert_same(got, _tree(2))


def test_keep_last_k(tmp_path):
    mgr = tckpt.CheckpointManager(tmp_path, keep=2)
    for s in range(5):
        mgr.save(s, _tree(s))
    assert sorted(mgr.steps()) == [3, 4]
    got, _ = mgr.restore(_tree(), step=3)
    _assert_same(got, _tree(3))


def test_async_save_completes_before_restore(tmp_path):
    mgr = tckpt.CheckpointManager(tmp_path, keep=3, async_save=True)
    trees = [_tree(s) for s in range(4)]
    for s, t in enumerate(trees):
        mgr.save(s, t)          # one write in flight at a time
    got, meta = mgr.restore(_tree())    # waits for the last write
    assert meta["step"] == 3
    _assert_same(got, trees[3])
    assert sorted(mgr.steps()) == [1, 2, 3]
    assert json.loads((tmp_path / "step_3" / "meta.json").read_text())[
        "keys"] == sorted(tckpt._flatten(trees[3]))


def test_restore_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tckpt.CheckpointManager(tmp_path).restore(_tree())
