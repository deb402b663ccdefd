"""The port's directory checkpoints (``l3embedding_torch/training/
dir_checkpoints.py``, backed by ``torch.distributed.checkpoint``) in one
process: the round trip of ``tests/test_orbax_io.py`` at tiny_L3, restored
into a differently seeded state with step, params, BN statistics and Adam
state bit for bit, and a state from JAX's ``create_train_state`` carried
over through ``compat/from_jax.py``. A snapshot saved by 2 gloo ranks is
restored in ``tests/test_torch_port_parallel.py``, from its one job."""

import os

import numpy as np
import torch

from l3embedding_tpu.training import checkpoints as jax_ckpt
from l3embedding_torch.models.registry import build_model
from l3embedding_torch.training import checkpoints
from l3embedding_torch.training.dir_checkpoints import load_state_dir, save_state_dir
from l3embedding_torch.training.state import create_train_state
from test_torch_port_trainloop import assert_trees_equal, jax_template, trained_port_state
from torch_port_threads import one_torch_thread  # noqa: F401


def fresh(seed):
    return create_train_state(build_model("tiny_L3"), torch.Generator().manual_seed(seed), 1e-3, device="cpu")


def leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_round_trip_restores_every_leaf(tmp_path):
    """A trained state (Adam moments and step not zero) survives the round
    trip into a differently seeded state; a second save replaces the first."""
    state = trained_port_state(steps=2)
    path = str(tmp_path / "snap")
    save_state_dir(path, fresh(4))
    save_state_dir(path, state)
    assert sorted(os.listdir(path)) == [".metadata", "__0_0.distcp"]
    other = fresh(99)
    kernel = ("params", "audio_model", "Conv_0", "kernel")
    assert not np.array_equal(leaf(checkpoints.state_tree(other), kernel), leaf(checkpoints.state_tree(state), kernel))
    restored = load_state_dir(path, other)
    assert restored is other and restored.step == state.step == 2
    want = checkpoints.state_tree(state)
    assert_trees_equal(checkpoints.state_tree(restored), want)
    assert np.abs(leaf(want, ("opt_state", "0", "nu", "audio_model", "Conv_0", "kernel"))).max() > 0


def test_jax_state_survives_the_round_trip(tmp_path):
    """JAX's create_train_state → a .ckpt → compat/from_jax.py (through
    ``load_state_tree``) → a directory → a fresh port state: JAX's tree bit
    for bit."""
    jax_ckpt.save_state(str(tmp_path / "jax.ckpt"), jax_template("tiny_L3"))
    tree = checkpoints.read_tree(str(tmp_path / "jax.ckpt"))
    carried = checkpoints.load_state_tree(tree, fresh(5))
    save_state_dir(str(tmp_path / "snap"), carried)
    restored = load_state_dir(str(tmp_path / "snap"), fresh(6))
    assert_trees_equal(checkpoints.state_tree(restored), tree)
