"""The port's checkpoint store (`repro_torch.checkpoint`) against the JAX
package (`tests/test_optim_checkpoint.py`'s checkpoint cases): round trip,
gc, atomic saves, crc32 / truncation / missing-file detection, manifests
without checksums, the newest-intact fallback chain; a params checkpoint
written by one package and restored by the other, both ways, bf16
included, bit for bit; None as an empty subtree, as in JAX; PaME resumed
from a checkpoint equal to an uninterrupted run; and the trainer's
``--ckpt-dir`` resume equal to an uninterrupted run (the step-4
checkpoints of both runs bit for bit)."""
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.serve import events as jev
from repro_torch.checkpoint import (
    CheckpointCorruptError,
    latest_step,
    list_steps,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.launch import train as ttrain
from repro_torch.serve import events as tev

from _torch_parity import one_torch_thread, to_t  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones(2, dtype=torch.bfloat16), "c": [torch.zeros(3)]},
    }


def _zeros_like(tree):
    from repro_torch.tree import tree_map

    return tree_map(torch.zeros_like, tree)


def _leaf_files(step_dir):
    return sorted(f for f in os.listdir(step_dir) if f.endswith(".npy"))


def test_checkpoint_roundtrip_and_gc():
    tree = _tree()
    with tempfile.TemporaryDirectory() as d:
        for step in (10, 20, 30, 40):
            save_checkpoint(d, step, tree, keep=2)
        assert list_steps(d) == [30, 40] and latest_step(d) == 40
        back = restore_checkpoint(d, _zeros_like(tree))
        assert torch.equal(back["a"], tree["a"])
        assert back["nested"]["b"].dtype == torch.bfloat16
        assert torch.equal(back["nested"]["b"], tree["nested"]["b"])
        with open(os.path.join(d, "step_000000040", "manifest.json")) as f:
            manifest = json.load(f)
        assert [m["dtype"] for m in manifest["leaves"]] == ["float32", "bfloat16", "float32"]


def test_checkpoint_shape_mismatch_rejected():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, {"a": torch.zeros(3)})
        with pytest.raises(ValueError):
            restore_checkpoint(d, {"a": torch.zeros(4)})
        with pytest.raises(ValueError, match="leaves"):
            restore_checkpoint(d, {"a": torch.zeros(3), "b": torch.zeros(1)})


def test_checkpoint_save_is_atomic_no_tmp_left():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 3, {"a": torch.arange(6, dtype=torch.float32)})
        assert not [x for x in os.listdir(d) if x.endswith(".tmp")]
        os.makedirs(os.path.join(d, "step_000000009.tmp"))
        assert latest_step(d) == 3


def test_checkpoint_crc_mismatch_detected():
    tree = {"a": torch.arange(8, dtype=torch.float32)}
    with tempfile.TemporaryDirectory() as d:
        step_dir = save_checkpoint(d, 1, tree)
        fpath = os.path.join(step_dir, _leaf_files(step_dir)[0])
        with open(fpath, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            flipped = f.read(1)[0] ^ 0xFF
            f.seek(-1, os.SEEK_END)
            f.write(bytes([flipped]))
        with pytest.raises(CheckpointCorruptError, match="crc32 mismatch"):
            restore_checkpoint(d, tree)


def test_checkpoint_truncated_leaf_detected():
    tree = {"a": torch.arange(64, dtype=torch.float32)}
    with tempfile.TemporaryDirectory() as d:
        step_dir = save_checkpoint(d, 1, tree)
        fpath = os.path.join(step_dir, _leaf_files(step_dir)[0])
        with open(fpath, "r+b") as f:
            f.truncate(os.path.getsize(fpath) - 40)
        with pytest.raises(CheckpointCorruptError, match="truncated"):
            restore_checkpoint(d, tree)


def test_checkpoint_missing_leaf_and_manifest_detected():
    tree = {"a": torch.arange(4, dtype=torch.float32)}
    with tempfile.TemporaryDirectory() as d:
        step_dir = save_checkpoint(d, 1, tree)
        os.remove(os.path.join(step_dir, _leaf_files(step_dir)[0]))
        with pytest.raises(CheckpointCorruptError, match="missing"):
            restore_checkpoint(d, tree)
    with tempfile.TemporaryDirectory() as d:
        step_dir = save_checkpoint(d, 1, tree)
        with open(os.path.join(step_dir, "manifest.json"), "w") as f:
            f.write("{not json")
        with pytest.raises(CheckpointCorruptError, match="not valid JSON"):
            restore_checkpoint(d, tree)
    with tempfile.TemporaryDirectory() as d:
        step_dir = save_checkpoint(d, 1, tree)
        os.remove(os.path.join(step_dir, "manifest.json"))
        with pytest.raises(CheckpointCorruptError, match="manifest"):
            restore_checkpoint(d, tree)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(FileNotFoundError):
            restore_checkpoint(d, tree)


def test_checkpoint_backward_compat_manifest_without_crc():
    tree = {"a": torch.arange(5, dtype=torch.float32)}
    with tempfile.TemporaryDirectory() as d:
        step_dir = save_checkpoint(d, 1, tree)
        mpath = os.path.join(step_dir, "manifest.json")
        with open(mpath) as f:
            manifest = json.load(f)
        for leaf in manifest["leaves"]:
            leaf.pop("crc32")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        back = restore_checkpoint(d, _zeros_like(tree))
        assert torch.equal(back["a"], tree["a"])


def test_restore_falls_back_to_newest_intact_step():
    with tempfile.TemporaryDirectory() as d:
        trees = {s: {"a": torch.full((16,), float(s))} for s in (10, 20, 30)}
        for s, tree in trees.items():
            save_checkpoint(d, s, tree, keep=5)
        dir30 = os.path.join(d, "step_000000030")
        fpath = os.path.join(dir30, _leaf_files(dir30)[0])
        with open(fpath, "r+b") as f:
            f.truncate(os.path.getsize(fpath) - 24)
        assert torch.equal(restore_checkpoint(d, trees[10])["a"], trees[20]["a"])
        with pytest.raises(CheckpointCorruptError, match="truncated"):
            restore_checkpoint(d, trees[10], 30)
        dir20 = os.path.join(d, "step_000000020")
        with open(os.path.join(dir20, _leaf_files(dir20)[0]), "r+b") as f:
            f.seek(-1, os.SEEK_END)
            flipped = f.read(1)[0] ^ 0xFF
            f.seek(-1, os.SEEK_END)
            f.write(bytes([flipped]))
        assert torch.equal(restore_checkpoint(d, trees[10])["a"], trees[10]["a"])
        os.remove(os.path.join(d, "step_000000010", "manifest.json"))
        with pytest.raises(CheckpointCorruptError, match="truncated"):
            restore_checkpoint(d, trees[10])


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
def _params_np():
    rng = np.random.default_rng(3)
    return {"emb": rng.standard_normal((4, 6, 3)).astype(np.float32),
            "groups": [{"w": jnp.asarray(rng.standard_normal((4, 2, 5)), jnp.bfloat16),
                        "ln": rng.standard_normal((4, 5)).astype(np.float32)}],
            "steps": rng.integers(0, 9, (4,)).astype(np.int32)}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_params_checkpoint_crosses_packages_bitwise(writer):
    """A params tree written by one package restores in the other bit for
    bit (bf16 widened on disk and narrowed back); the manifests name the
    same files, dtypes, shapes and checksums."""
    tree_np = _params_np()
    jtree = jax.tree_util.tree_map(jnp.asarray, tree_np)
    ttree = jax.tree_util.tree_map(to_t, tree_np)
    with tempfile.TemporaryDirectory() as dj, tempfile.TemporaryDirectory() as dt:
        jsave(dj, 7, jtree)
        save_checkpoint(dt, 7, ttree)
        with open(os.path.join(dj, "step_000000007", "manifest.json")) as f:
            mj = json.load(f)
        with open(os.path.join(dt, "step_000000007", "manifest.json")) as f:
            mt = json.load(f)
        assert mj == mt
        if writer == "jax":
            back = restore_checkpoint(dj, jax.tree_util.tree_map(torch.zeros_like, ttree))
            for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ttree)):
                assert g.dtype == w.dtype and torch.equal(g, w)
        else:
            back = jrestore(dt, jax.tree_util.tree_map(jnp.zeros_like, jtree))
            for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jtree)):
                g, w = np.asarray(g), np.asarray(w)
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


def test_none_is_an_empty_subtree_as_in_jax():
    """A paced carry without faults (`PacedCarry(events, inner=None)`) has
    the same leaves on disk as JAX's, and restores with inner still None."""
    jes = jev.ServePacing(jev.ArrivalProcess(rate=1.0)).init(3)
    tes = tev.ServePacing(tev.ArrivalProcess(rate=1.0)).init(3)
    with tempfile.TemporaryDirectory() as dj, tempfile.TemporaryDirectory() as dt:
        jsave(dj, 1, {"aux": jev.PacedCarry(jes, None)})
        save_checkpoint(dt, 1, {"aux": tev.PacedCarry(tes, None)})
        fj = _leaf_files(os.path.join(dj, "step_000000001"))
        ft = _leaf_files(os.path.join(dt, "step_000000001"))
        assert len(ft) == len(fj) == 6
        assert ft[:5] == fj[:5]  # the key leaf: a PRNG key in JAX, the seed here
        back = restore_checkpoint(dt, {"aux": tev.PacedCarry(tes, None)})
        assert back["aux"].inner is None and back["aux"].events.key == tes.key
        assert torch.equal(back["aux"].events.queue, tes.queue)


def test_python_numbers_and_numpy_leaves_round_trip():
    tree = {"n": 5, "x": 0.25, "arr": np.arange(3, dtype=np.float64), "t": torch.ones(2)}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 2, tree)
        back = restore_checkpoint(d, {"n": 0, "x": 0.0, "arr": np.zeros(3), "t": torch.zeros(2)})
        assert back["n"] == 5 and isinstance(back["n"], int) and back["x"] == 0.25
        np.testing.assert_array_equal(back["arr"], tree["arr"])
        assert torch.equal(back["t"], tree["t"])


def test_train_driver_resume_consistency():
    """PaME state saved at step 5, restored and run on: equal to an
    uninterrupted run (counter-mode draws make it exact)."""
    from repro_torch.core import PaMEConfig, build_topology
    from repro_torch.core.pame import make_topology_arrays, pame_init, pame_step

    m = 4
    topo = build_topology("complete", m)
    cfg = PaMEConfig(nu=0.5, p=0.5, gamma=1.05, sigma0=8.0, homogeneous_kappa=2)
    arrs = make_topology_arrays(topo, cfg, device="cpu")
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((m, 16, 6)).astype(np.float32))
    y = torch.as_tensor(rng.standard_normal((m, 16)).astype(np.float32))

    def grad_fn(p, batch, key):
        aa, yy = batch
        r = aa @ p["w"] - yy
        return 0.5 * torch.mean(r ** 2), {"w": aa.T @ r / aa.shape[0]}

    def roll(state, steps):
        for _ in range(steps):
            state, _ = pame_step(state, (a, y), grad_fn, arrs, cfg)
        return state

    s_full = roll(pame_init(0, {"w": torch.zeros(m, 6)}, m, cfg), 10)
    s_half = roll(pame_init(0, {"w": torch.zeros(m, 6)}, m, cfg), 5)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 5, s_half)
        restored = restore_checkpoint(d, s_half)
    assert restored.step == 5 and restored.key == s_half.key
    assert torch.equal(roll(restored, 5).params["w"], s_full.params["w"])


CLI = ["--arch", "stablelm-1.6b", "--variant", "smoke", "--layers", "1", "--nodes", "4",
       "--batch", "1", "--seq", "16", "--chunk", "2", "--ckpt-every", "2", "--device", "cpu"]


@pytest.mark.parametrize("flags", [[], ["--loss-rate", "0.2"]])
def test_trainer_resume_equals_uninterrupted_run(tmp_path, flags, capsys):
    """The trainer for 2 steps and then for 4 from the same --ckpt-dir: it
    resumes at step 2, and its step-4 checkpoint (state, carry and realized
    wire bits) equals an uninterrupted 4-step run's bit for bit."""
    whole, split = str(tmp_path / "whole"), str(tmp_path / "split")
    ttrain.main(CLI + flags + ["--steps", "4", "--ckpt-dir", whole])
    first = ttrain.main(CLI + flags + ["--steps", "2", "--ckpt-dir", split])
    second = ttrain.main(CLI + flags + ["--steps", "4", "--ckpt-dir", split])
    assert first["start"] == 0 and second["start"] == 2 and second["steps"] == 4
    assert second["restore"]["step"] == 2 and second["restore"]["bytes"] > 0
    assert [c["step"] for c in second["checkpoints"]] == [4]
    assert "[train] resumed from step 2" in capsys.readouterr().out
    a, b = (os.path.join(d, "step_000000004") for d in (whole, split))
    files = _leaf_files(a)
    assert files == _leaf_files(b)
    for f in files:
        np.testing.assert_array_equal(np.load(os.path.join(a, f)), np.load(os.path.join(b, f)))
