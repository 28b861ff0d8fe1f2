"""The port's checkpoints against the JAX package's.

``ray_tpu_torch.checkpoint`` writes the reference's store format (content-
addressed chunks, per-rank shard files, an atomic manifest): the port's
``ShardWriter`` round-trips torch tensors and numpy arrays, bfloat16 bit
for bit (its raw bytes under the name ``bfloat16``), sharded saves
restore resharded, and an fp32 checkpoint written by either package
restores through the other's ``restore_tree`` to the same arrays.
``air.Checkpoint.from_state_dict`` round-trips a state dict, the
``CheckpointManager`` persists it under a storage path, and the RL
algorithms save and load their Anakin parameters and iteration."""
import numpy as np
import pytest
import torch

import ray_tpu.checkpoint as jckpt
import ray_tpu_torch.checkpoint as tckpt


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_bits(a, b):
    assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and \
        a.shape == b.shape
    assert torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.randn(6, 4, generator=g),
                   "b16": torch.randn(4, 3, generator=g).to(torch.bfloat16),
                   "ids": torch.arange(10, dtype=torch.int32)},
        "opt": [np.float32(3.0), rng.standard_normal(5)],
        "step": 7,
    }


def test_shard_writer_round_trips_tensors_and_bf16(tmp_path):
    tree = _tree()
    stats = tckpt.save_tree(str(tmp_path), tree, step=1, meta={"k": "v"})
    assert stats["manifest"]["meta"] == {"k": "v"}
    got = tckpt.restore_tree(str(tmp_path))
    _same_bits(tree["params"]["b16"], got["params"]["b16"])
    np.testing.assert_array_equal(got["params"]["w"],
                                  tree["params"]["w"].numpy())
    assert got["params"]["w"].dtype == np.float32
    np.testing.assert_array_equal(got["params"]["ids"], np.arange(10))
    assert got["opt"][0] == np.float32(3.0)
    np.testing.assert_array_equal(got["opt"][1], tree["opt"][1])
    assert int(got["step"]) == 7
    # With a target, the container types and Python scalars come back.
    like = tckpt.restore_tree(str(tmp_path), target=tree)
    assert like["step"] == 7 and isinstance(like["opt"], list)


def test_a_resave_of_unchanged_state_writes_no_chunk(tmp_path):
    tree = _tree()
    first = tckpt.save_tree(str(tmp_path), tree, step=1)
    second = tckpt.save_tree(str(tmp_path), tree, step=2)
    assert first["bytes_written"] > 0
    assert second["bytes_written"] == 0 and second["chunks_reused"] > 0
    assert tckpt.committed_steps(str(tmp_path)) == [1, 2]


def test_two_rank_sharded_save_restores_whole_and_resharded(tmp_path):
    """Each of two ranks holds half of axis 0 (a bf16 tensor and an fp32
    one) and a replicated bias; the whole array comes back, and a
    three-rank restore takes its even slice."""
    root = str(tmp_path)
    full = torch.randn(6, 4).to(torch.bfloat16)
    dense = torch.randn(6, 2)
    bias = torch.randn(3)
    for rank in range(2):
        writer = tckpt.ShardWriter(root, rank, 2)
        rows = slice(3 * rank, 3 * rank + 3)
        snap = writer.snapshot({"e": full[rows], "d": dense[rows],
                                "bias": bias})
        writer.persist_async(
            snap, step=5, index_fn=tckpt.axis0_shard_index(
                rank, 2, should_shard=lambda p: "bias" not in p))
        writer.wait(timeout=30)
    tckpt.commit_manifest(root, 5, 2)
    whole = tckpt.restore_tree(root)
    _same_bits(full, whole["e"])
    np.testing.assert_array_equal(whole["d"], dense.numpy())
    np.testing.assert_array_equal(whole["bias"], bias.numpy())
    mine = tckpt.restore_tree(root, index_fn=tckpt.axis0_restore_index(1, 3))
    _same_bits(full[2:4], mine["e"])
    np.testing.assert_array_equal(mine["d"], dense[2:4].numpy())
    np.testing.assert_array_equal(mine["bias"], bias.numpy())


def test_commit_refuses_a_missing_rank(tmp_path):
    writer = tckpt.ShardWriter(str(tmp_path), 0, 2)
    writer.persist(writer.snapshot({"w": torch.ones(2)}), step=1)
    with pytest.raises(FileNotFoundError, match="ranks \\[1\\]"):
        tckpt.commit_manifest(str(tmp_path), 1, 2)
    assert tckpt.latest_committed_step(str(tmp_path)) is None


def _fp32_tree(seed=1):
    rng = np.random.default_rng(seed)
    return {"dense": {"kernel": rng.standard_normal((5, 3)).astype(np.float32),
                      "bias": rng.standard_normal(3).astype(np.float32)},
            "count": np.int64(4), "stack": [np.arange(6, dtype=np.int32)]}


def _assert_tree_equal(a, b):
    flat_a, flat_b = jckpt.flatten_with_paths(a), jckpt.flatten_with_paths(b)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, x), (_, y) in zip(flat_a, flat_b):
        x, y = np.asarray(x), np.asarray(y)
        assert (x.dtype, x.shape) == (y.dtype, y.shape)
        assert x.tobytes() == y.tobytes()


def _write_both(tmp_path, tree):
    """The same fp32 tree saved by each package: (port's root, JAX's)."""
    torch_tree = {"dense": {k: torch.from_numpy(v)
                            for k, v in tree["dense"].items()},
                  "count": tree["count"], "stack": tree["stack"]}
    port, jax = str(tmp_path / "port"), str(tmp_path / "jax")
    tckpt.save_tree(port, torch_tree, step=3)
    jckpt.save_tree(jax, tree, step=3)
    return port, jax


def test_both_packages_write_the_same_shard_metadata(tmp_path):
    """The same chunk hashes, dtypes, shapes and indices: one format."""
    port, jax = _write_both(tmp_path, _fp32_tree())
    assert tckpt.manifest.load_rank_metas(port, 3) == \
        jckpt.manifest.load_rank_metas(jax, 3)


@pytest.mark.parametrize("reader", ["ray_tpu", "ray_tpu_torch"])
def test_each_package_restores_the_others_checkpoint(tmp_path, reader):
    """Either package's restore_tree gives the same arrays from the
    port's checkpoint as from the JAX package's, and the arrays of the
    saved tree (a 0-d leaf comes back as shape (1,) in both: the savers
    pass it through ``np.ascontiguousarray``, which returns at least one
    dimension)."""
    tree = _fp32_tree(2)
    port, jax = _write_both(tmp_path, tree)
    restore = {"ray_tpu": jckpt, "ray_tpu_torch": tckpt}[reader].restore_tree
    from_port, from_jax = restore(port), restore(jax)
    _assert_tree_equal(from_port, from_jax)
    for key in ("kernel", "bias"):
        np.testing.assert_array_equal(from_port["dense"][key],
                                      tree["dense"][key])
    np.testing.assert_array_equal(from_port["stack"][0], tree["stack"][0])
    assert from_port["count"].tolist() == [4]


def test_state_dict_checkpoint_round_trips():
    from ray_tpu_torch.air import Checkpoint

    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.LayerNorm(3))
    model[0].to(torch.bfloat16)
    opt = torch.optim.AdamW(model.parameters())
    state = {"model": model.state_dict(), "opt": opt.state_dict()}
    ckpt = Checkpoint.from_state_dict(state, extra={"iteration": 3})
    assert ckpt.extra() == {"iteration": 3}
    got = ckpt.to_state_dict()
    assert list(got["model"]) == list(state["model"])
    for k, t in state["model"].items():
        _same_bits(t, got["model"][k])
    assert got["opt"]["param_groups"] == state["opt"]["param_groups"]
    # Through a directory and back.
    again = Checkpoint.from_directory(ckpt.to_directory()).to_state_dict()
    for k, t in state["model"].items():
        _same_bits(t, again["model"][k])


def test_manager_persists_state_dict_checkpoints_under_a_storage_path(
        tmp_path):
    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.air.checkpoint_manager import (
        CheckpointManager, discover_latest_checkpoint)
    from ray_tpu_torch.air.config import CheckpointConfig

    manager = CheckpointManager(CheckpointConfig(num_to_keep=2),
                                storage_path=str(tmp_path))
    weights = [torch.full((3,), float(i)) for i in range(4)]
    for i, w in enumerate(weights):
        manager.register(Checkpoint.from_state_dict({"w": w}), {"loss": -i})
    assert tckpt.committed_steps(str(tmp_path)) == [3, 4]
    latest = discover_latest_checkpoint(str(tmp_path))
    assert latest.step == 4 and latest.extra() == {"loss": -3}
    _same_bits(weights[-1], latest.to_state_dict()["w"])


@pytest.mark.parametrize("kind", ["ppo", "impala"])
def test_algorithm_checkpoint_restores_parameters_and_iteration(kind):
    """Anakin save -> train on -> load: the module's parameters come back
    bit for bit and the iteration with them; a fresh algorithm loading
    the checkpoint holds the same parameters."""
    from ray_tpu_torch.rllib import IMPALAConfig, PPOConfig

    config_cls = {"ppo": PPOConfig, "impala": IMPALAConfig}[kind]

    def build():
        return config_cls().environment("CartPole-v1").anakin(
            num_envs=8, unroll_length=8).resources(device="cpu").debugging(
                seed=0).build()

    algo = build()
    algo.train()
    saved = {k: t.clone() for k, t in algo.module.state_dict().items()}
    ckpt = algo.save_checkpoint()
    algo.train()
    assert algo.iteration == 2
    assert any(not torch.equal(t, saved[k])
               for k, t in algo.module.state_dict().items())
    algo.load_checkpoint(ckpt)
    assert algo.iteration == 1
    for k, t in algo.module.state_dict().items():
        _same_bits(saved[k], t)
    fresh = build()
    fresh.load_checkpoint(ckpt)
    assert fresh.iteration == 1
    for k, t in fresh.module.state_dict().items():
        _same_bits(saved[k], t)
    fresh.train()  # the optimizer still steps the loaded parameters
    assert fresh.iteration == 2
