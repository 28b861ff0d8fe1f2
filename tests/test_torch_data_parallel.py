"""The port's data parallelism against the JAX package's: the Train
helpers over a gang (``get_mesh``, ``prepare_train_state``,
``prepare_batch``, ``compile_zero_step``, ``prepare_model``), the
``MeshGroup`` gang (collectives, restarts, the step pipeline), the
checkpoint coordinator, ``DistributedLearnerGroup``, and the
backend-choice rule of ``TorchConfig``.

Where the JAX package shards one program over W of the 8 virtual CPU
devices (``tests/conftest.py``), the port runs W gloo ranks: processes of
one module cluster, torch on one thread a rank.  GPT-2 tiny (fp32,
weights converted from flax) trains through ``TorchTrainer`` with two
workers against one and against JAX's ``compile_zero_step`` over two
devices, at the tolerance of ``test_train.py``'s
``test_gpt2_dp_two_workers_matches_single_process`` (rtol 1e-4, atol
1e-5).  Every get and every gang call has a timeout; training loops and
rank functions ship by value."""
import shutil
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

T = 120  # seconds: the bound of every get and gang call
DP_RTOL, DP_ATOL = 1e-4, 1e-5
STEPS, LR = 6, 1e-3
# test_zero.py::test_gpt2_int8_collectives_loss_envelope's envelope.
INT8_ENVELOPE = 0.05


@pytest.fixture(scope="module", autouse=True)
def one_thread_and_fns_by_value():
    import sys

    import cloudpickle

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    yield
    cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rt():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                       object_store_memory=256 * 1024**2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# the backend rule (the decision only)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gpus,cards,want", [
    (0.5, [("h", "0"), ("h", "0")], "gloo"),   # two ranks share a card
    (0.0, [("h", ""), ("h", "")], "gloo"),     # the CPU
    (1.0, [("h", "0"), ("h", "1")], "nccl"),   # a card each
    (1.0, [("a", "0"), ("b", "0")], "nccl"),   # a card each, two hosts
    (2.0, [("h", "0,1"), ("h", "2,3")], "nccl"),
    (1.0, [("h", "0"), ("h", "0")], None),     # whole cards, one device
    (1.0, [("h", "0"), ("h", "")], None),      # a GPU asked, none seen
    (1.5, [("h", "0"), ("h", "1")], None),
])
def test_process_group_backend(gpus, cards, want):
    from ray_tpu_torch.parallel.mesh_group import process_group_backend

    if want is None:
        with pytest.raises(RuntimeError):
            process_group_backend(gpus, cards)
    else:
        assert process_group_backend(gpus, cards) == want


# ---------------------------------------------------------------------------
# GPT-2 tiny through TorchTrainer: 2 workers = 1 worker = JAX
# ---------------------------------------------------------------------------
MODES = ("opt+grads", "opt", "int8", "ddp")


def _gpt2_tiny():
    from ray_tpu.models import GPT2, GPT2Config
    from ray_tpu_torch.models.convert import gpt2_params_from_jax

    model = GPT2(GPT2Config.tiny(dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    ids = np.random.default_rng(0).integers(0, 512, (8, 32))
    state = gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        params))
    return model, params, ids, {k: v.numpy() for k, v in state.items()}


def _dp_loop(config):
    """Each mode from the same weights on the same global batch, this
    rank on its slice: the ZeRO step (both wires, ZeRO-1 and -2) and a
    DDP model; the losses averaged over the gang."""
    import torch

    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import GPT2, GPT2Config, gpt2_loss_fn
    from ray_tpu_torch.ops import collectives
    from ray_tpu_torch.train.torch import (
        compile_zero_step, get_mesh, prepare_batch, prepare_model,
        prepare_train_state)

    torch.set_num_threads(1)
    mesh = get_mesh()
    batch = prepare_batch({"input_ids": torch.from_numpy(config["ids"])},
                          mesh)
    out, info = {}, None
    for mode in MODES:
        model = GPT2(GPT2Config.tiny(dtype=torch.float32))
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in config["state"].items()})
        losses = []
        if mode == "ddp":
            ddp = prepare_model(model)
            opt = torch.optim.Adam(ddp.parameters(), LR, eps=1e-8)
            for _ in range(STEPS):
                opt.zero_grad()
                loss = gpt2_loss_fn(ddp, batch)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
        else:
            params = prepare_train_state(dict(model.named_parameters()),
                                         mesh)

            def grad_fn(p, b):
                loss = gpt2_loss_fn(model, b)
                return loss, dict(zip(p, torch.autograd.grad(
                    loss, list(p.values()))))

            step, opt, info = compile_zero_step(
                grad_fn, lambda ps: torch.optim.Adam(ps, LR, eps=1e-8),
                params, mesh,
                zero_sharding="opt" if mode == "opt" else "opt+grads",
                quantized_collectives="int8" if mode == "int8" else "off")
            for _ in range(STEPS):
                params, opt, loss = step(params, opt, batch)
                losses.append(loss)
        if mode == "ddp" and mesh.world > 1:
            losses = [collectives.all_reduce_sum(x) / mesh.world
                      for x in losses]
        out[mode] = [float(x) for x in losses]
    session.report({"losses": out, "world": mesh.world,
                    "shape": mesh.shape, "info": info})


def _fit(num_workers, ids, state):
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train import TorchTrainer

    result = TorchTrainer(
        _dp_loop, train_loop_config={"ids": ids, "state": state},
        scaling_config=ScalingConfig(num_workers=num_workers,
                                     use_gpu=False)).fit()
    assert result.error is None, result.error
    return result.metrics


def _jax_zero_losses(model, params, ids, world=2):
    from ray_tpu.models.gpt2 import gpt2_loss_fn
    from ray_tpu.rllib.utils import mesh as mesh_util
    from ray_tpu.train.jax import compile_zero_step

    def grad_fn(p, x):
        return jax.value_and_grad(gpt2_loss_fn)(p, model.apply,
                                                {"input_ids": x})

    step, opt, info = compile_zero_step(
        grad_fn, optax.adam(LR), params, mesh_util.data_mesh(world),
        donate=False)
    p, losses = params, []
    for _ in range(STEPS):
        p, opt, loss = step(p, opt, jnp.asarray(ids))
        losses.append(float(loss))
    return losses, info


def test_gpt2_dp_two_workers_match_one_and_jax(rt):
    """Two gloo workers against one: each mode's losses within (rtol
    1e-4, atol 1e-5); ZeRO-2, ZeRO-1 and the DDP wrap against JAX's
    ``compile_zero_step`` over two devices at the same tolerance (the
    same Adam: each mode is one data-parallel step); the int8 wire within
    ``INT8_ENVELOPE`` of the fp32 wire, both falling; the memory and wire
    envelope equal to JAX's."""
    model, params, ids, state = _gpt2_tiny()
    one = _fit(1, ids, state)
    two = _fit(2, ids, state)
    assert (one["world"], two["world"]) == (1, 2)
    assert two["shape"] == {"data": 2}
    for mode in MODES:
        np.testing.assert_allclose(two["losses"][mode], one["losses"][mode],
                                   rtol=DP_RTOL, atol=DP_ATOL)
    jax_losses, jax_info = _jax_zero_losses(model, params, ids)
    for mode in ("opt+grads", "opt", "ddp"):
        np.testing.assert_allclose(two["losses"][mode], jax_losses,
                                   rtol=DP_RTOL, atol=DP_ATOL, err_msg=mode)
    fp32, int8 = two["losses"]["opt+grads"], two["losses"]["int8"]
    assert fp32[-1] < fp32[0] and int8[-1] < int8[0]
    assert abs(int8[-1] - fp32[-1]) < INT8_ENVELOPE
    info = two["info"]  # the last ZeRO mode's: int8, ZeRO-2, world 2
    assert info["zero_opt_bytes_per_replica"] == \
        jax_info["zero_opt_bytes_per_replica"]
    assert info["replicated_opt_bytes"] == jax_info["replicated_opt_bytes"]
    assert info["zero_opt_bytes_per_replica"] <= \
        0.51 * info["replicated_opt_bytes"]


# ---------------------------------------------------------------------------
# the gang: MeshGroup, StepPipeline, the mesh helpers, the checkpointer
# ---------------------------------------------------------------------------
def _allsum():
    import torch
    import torch.distributed as dist

    x = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(x)
    return x.item()


def _mesh_view(seed_by_rank):
    """A rank's view of the mesh helpers: the mesh's shape and coords,
    its slice of a global batch, rank 0's parameters after
    ``prepare_train_state``, and a model-axis annotation degrading to
    replication."""
    import torch

    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.parallel.sharding import ShardingRules
    from ray_tpu_torch.train.torch import (
        get_mesh, prepare_batch, prepare_train_state)

    mesh = get_mesh()
    rank = mesh.rank
    torch.manual_seed(seed_by_rank[rank])
    params = {"w": torch.randn(4, 6), "b": torch.randn(6)}
    placed = prepare_train_state(params, mesh)
    sliced = prepare_train_state(
        {"w": params["w"].clone(), "b": params["b"].clone()}, mesh,
        annotations={"w": ("batch", "mlp"), "b": None})
    batch = prepare_batch({"x": torch.arange(8).reshape(8, 1)}, mesh)
    mesh2 = make_mesh(MeshSpec({"data": -1, "model": 1}))
    return {"shape": mesh.shape, "coords": mesh.coords,
            "x": batch["x"][:, 0].tolist(), "w": placed["w"],
            "w_slice": sliced["w"], "b": sliced["b"],
            "spec": ShardingRules().spec_for(("batch", "mlp", "heads"),
                                             mesh2)}


def test_mesh_group_gang(rt):
    """Two gloo ranks: the all-reduce; the mesh helpers; health checks;
    ``run_stateful``; a pipelined stream of 4 steps with no blocking
    driver sync; ``submit_ordered``; then rank 1 SIGKILLed inside a
    collective's step (the chaos schedule, generation 0) while rank 0
    blocks in the all-reduce: the gang is torn down, rebuilt in fresh
    processes (``restart_count`` 1, the restart hook and ``on_restart``
    called), and the call answers."""
    from ray_tpu_torch._private import chaos
    from ray_tpu_torch.parallel import MeshGroup, driver_sync_count, \
        gang_get

    mg = MeshGroup(2, bootstrap_timeout=T, max_group_restarts=1,
                   restart_backoff_s=0.1)
    try:
        assert [i["backend"] for i in mg.device_info] == ["gloo", "gloo"]
        assert mg.world_size == 2
        assert mg.run(_allsum, timeout=T) == [3.0, 3.0]
        views = mg.run(_mesh_view, {0: 1, 1: 2}, timeout=T)
        assert [v["shape"] for v in views] == [{"data": 2}] * 2
        assert [v["coords"] for v in views] == [{"data": 0}, {"data": 1}]
        assert views[0]["x"] == [0, 1, 2, 3] and views[1]["x"] == \
            [4, 5, 6, 7]
        torch.manual_seed(1)
        w0 = torch.randn(4, 6)
        for v in views:
            assert torch.equal(v["w"], w0)
        assert torch.equal(views[1]["w_slice"], w0[2:])
        assert torch.equal(views[0]["b"], views[1]["b"])
        assert views[0]["spec"] == (("data",), (), ())
        assert mg.health_check(deadline=T) == [0, 1]
        mg.run_stateful(lambda s: s.update(n=0), timeout=T)

        def bump(state, k):
            state["n"] += k
            return state["n"]

        before = driver_sync_count()
        got = mg.run_pipelined(bump, 4, 1, depth=2, timeout=T)
        assert driver_sync_count() == before
        assert [r for _, r in got] == [[1, 1], [2, 2], [3, 3], [4, 4]]
        refs = mg.submit_ordered(4, [(bump, 10), (bump, 20)])
        assert gang_get(refs, timeout=T) == [14, 24]

        hooks, restarts = [], []
        mg.add_restart_hook(lambda g: hooks.append(g.restart_count))
        gang_get([w.setup_env.remote({chaos.KILL_SCHEDULE_ENV:
                                      "mesh_run:1:1:0"})
                  for w in mg.workers], timeout=T)
        t0 = __import__("time").monotonic()
        assert mg.run(_allsum, timeout=T,
                      on_restart=lambda g: restarts.append(1)) == [3.0, 3.0]
        assert __import__("time").monotonic() - t0 < T / 2
        assert mg.restart_count == 1 and hooks == [1] and restarts == [1]
    finally:
        mg.shutdown()


class _LocalGang:
    """The JAX ``DistributedCheckpointer``'s view of a gang, in this
    process: ``run_stateful`` runs the rank function once a rank, in rank
    order, with the rank's state and ``RTPU_RANK``/``RTPU_WORLD_SIZE``
    set as a gang's worker has them."""

    def __init__(self, num_hosts, monkeypatch):
        self.num_hosts = num_hosts
        self.states = [{} for _ in range(num_hosts)]
        self._mp = monkeypatch

    def run_stateful(self, fn, *args):
        out = []
        for rank, state in enumerate(self.states):
            self._mp.setenv("RTPU_RANK", str(rank))
            self._mp.setenv("RTPU_WORLD_SIZE", str(self.num_hosts))
            out.append(fn(state, *args))
        return out


def test_distributed_checkpointer(rt, monkeypatch):
    """Lockstep and async sharded saves of a gang's rank trees commit and
    ``latest_step`` follows; the JAX package's ``DistributedCheckpointer``
    saving the same trees from the same two ranks writes the same shard
    metadata (chunk hashes, dtypes, shapes, indices), and each package's
    ``restore_tree`` reads the other's committed step bit for bit."""
    import ray_tpu.checkpoint as jckpt
    from ray_tpu.checkpoint.coordinator import \
        DistributedCheckpointer as JaxCheckpointer
    from ray_tpu_torch.checkpoint import DistributedCheckpointer, \
        restore_tree
    from ray_tpu_torch.checkpoint import manifest as tmf
    from ray_tpu_torch.parallel import MeshGroup

    def tree_fn(state):
        import torch

        return {"w": torch.arange(6.0) * state["k"]}

    def jax_tree_fn(state):
        return {"w": np.arange(6.0, dtype=np.float32) * state["k"]}

    mg = MeshGroup(2, bootstrap_timeout=T)
    root = tempfile.mkdtemp(prefix="rttp_coord_")
    jroot = tempfile.mkdtemp(prefix="rttp_coord_jax_")
    try:
        mg.run_stateful(lambda s: s.update(k=2.0), timeout=T)
        ckpt = DistributedCheckpointer(mg, root, tree_fn, num_to_keep=1)
        manifest = ckpt.save(1)
        assert manifest["world_size"] == 2 and ckpt.latest_step() == 1
        mg.run_stateful(lambda s: s.update(k=3.0), timeout=T)
        ckpt.save_async(2)
        ckpt.flush(timeout=T)
        assert ckpt.latest_step() == 2
        gang = _LocalGang(2, monkeypatch)
        jck = JaxCheckpointer(gang, jroot, jax_tree_fn, num_to_keep=1)
        gang.run_stateful(lambda s: s.update(k=2.0))
        jck.save(1)
        gang.run_stateful(lambda s: s.update(k=3.0))
        jck.save_async(2)
        jck.flush(timeout=T)
        assert jck.latest_step() == 2
        assert tmf.load_rank_metas(root, 2) == \
            jckpt.manifest.load_rank_metas(jroot, 2)
        want = np.arange(6.0, dtype=np.float32) * 3.0
        for got in (restore_tree(root, target={"w": np.zeros(6, np.float32)}),
                    restore_tree(jroot), jckpt.restore_tree(root)):
            assert np.asarray(got["w"]).tobytes() == want.tobytes()
    finally:
        mg.shutdown()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(jroot, ignore_errors=True)


# ---------------------------------------------------------------------------
# DistributedLearnerGroup
# ---------------------------------------------------------------------------
def _make_learner():
    import torch

    from ray_tpu_torch.rllib.core.learner import TorchLearner

    torch.set_num_threads(1)
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                              torch.nn.Linear(8, 1))

    def loss_fn(module, batch):
        pred = module(batch["x"])[:, 0]
        loss = ((pred - batch["y"]) ** 2).mean()
        return loss, {"mse": loss}

    return TorchLearner(net, loss_fn, lr=1e-2, device="cpu")


def _rank_weights(state):
    return state["learner"].get_weights()


def _jax_learner(weights):
    """The JAX learner on the same MLP, plan and weights: ``JaxLearner``
    over a 2-device ``data`` mesh (the batch split in two, the gradient
    reduced in-graph), ``clip_by_global_norm(1e9)`` then ``adam(1e-2)``
    as ``TorchLearner``'s plan, the port's weights converted (a
    ``Linear``'s ``[out, in]`` weight is a ``Dense``'s ``[in, out]``
    kernel)."""
    from flax import linen as nn

    from ray_tpu.rllib.core.learner import JaxLearner
    from ray_tpu.rllib.utils.mesh import data_mesh

    class MLP(nn.Module):
        @nn.compact
        def __call__(self, x):
            hidden = nn.Dense(8)(x)  # Dense_0, then Dense_1
            return nn.Dense(1)(nn.relu(hidden))

    def loss_fn(params, module, batch):
        pred = module.apply(params, batch["x"])
        loss = jnp.mean((pred[:, 0] - batch["y"]) ** 2)
        return loss, {"mse": loss}

    jl = JaxLearner(MLP(), loss_fn, optimizer=optax.chain(
        optax.clip_by_global_norm(1e9), optax.adam(1e-2)),
        mesh=data_mesh(2), example_obs=jnp.zeros((2, 4)))
    converted = {"params": {
        f"Dense_{i}": {"kernel": weights[f"{j}.weight"].numpy().T,
                       "bias": weights[f"{j}.bias"].numpy()}
        for i, j in ((0, 0), (1, 2))}}
    jl.set_weights(jax.tree_util.tree_map(
        lambda _, w: jnp.asarray(w), jl.get_weights(), converted))
    return jl


def _jax_weights(jl):
    p = jl.get_weights()["params"]
    return {f"{j}.{name}": np.asarray(
        p[f"Dense_{i}"][key]).T if key == "kernel" else
        np.asarray(p[f"Dense_{i}"][key])
        for i, j in ((0, 0), (1, 2))
        for name, key in (("weight", "kernel"), ("bias", "bias"))}


# Two ranks on halves against one program on the whole batch: the means
# of the halves' means (one division more) and another order of the
# sums; measured <= 1.2e-7 apart in the losses and <= 5e-8 in the
# weights after 10 updates.
LEARNER_RTOL, LEARNER_ATOL = 1e-5, 1e-6


def test_distributed_learner_group_two_hosts(rt):
    """Two ranks learn (the counterpart of test_mesh_group.py's test):
    the losses equal one ``TorchLearner``'s and JAX's ``JaxLearner``'s
    over a 2-device mesh on the same batches and weights within
    ``LEARNER_RTOL``, and so do the final weights; the ranks' weights
    are the same bits; a sharded checkpoint commits and the JAX
    package's ``restore_tree`` reads it; rank 1 SIGKILLed, the next
    update fails naming it; a one-rank group restores the checkpoint
    bit for bit."""
    import ray_tpu.checkpoint as jckpt
    from ray_tpu.rllib.core.learner import metrics_to_host as jax_to_host
    from ray_tpu_torch import exceptions as exc
    from ray_tpu_torch._private import chaos
    from ray_tpu_torch.rllib.core.learner import (
        DistributedLearnerGroup, metrics_to_host)

    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.float32)
    root = tempfile.mkdtemp(prefix="rttp_dlg_")
    lg = DistributedLearnerGroup(_make_learner, num_hosts=2,
                                 checkpoint_root=root)
    try:
        single = _make_learner()
        jl = _jax_learner(single.get_weights())
        losses, want, jax_losses = [], [], []
        for _ in range(10):
            losses.append(lg.update({"x": x, "y": y})["total_loss"])
            want.append(metrics_to_host(single.update(
                {"x": x, "y": y}))["total_loss"])
            jax_losses.append(jax_to_host(jl.update(
                {"x": x, "y": y}))["total_loss"])
        assert losses[-1] < losses[0]
        np.testing.assert_allclose(losses, want, rtol=LEARNER_RTOL)
        np.testing.assert_allclose(losses, jax_losses, rtol=LEARNER_RTOL)
        w0, w1 = lg.group.run_stateful(_rank_weights, timeout=T)
        for k in w0:
            assert torch.equal(w0[k], w1[k]), k
        jw = _jax_weights(jl)
        for k in w0:
            np.testing.assert_allclose(w0[k].numpy(), jw[k],
                                       rtol=LEARNER_RTOL,
                                       atol=LEARNER_ATOL, err_msg=k)
        manifest = lg.checkpoint_weights()
        assert manifest["world_size"] == 2
        saved = lg.get_weights()
        by_jax = jckpt.restore_tree(root, step=manifest["step"])
        assert sorted(by_jax) == sorted(saved)
        for k in saved:
            assert np.asarray(by_jax[k]).tobytes() == \
                saved[k].numpy().tobytes(), k
        assert chaos.kill_mesh_rank(lg.group, 1) == 1
        with pytest.raises(exc.MeshGroupError) as e:
            lg.update({"x": x, "y": y})
        assert 1 in e.value.failed_ranks
    finally:
        lg.shutdown()
    one = DistributedLearnerGroup(_make_learner, num_hosts=1,
                                  checkpoint_root=root)
    try:
        assert one.restore_latest() == manifest["step"]
        got = one.get_weights()
        for k in saved:
            assert torch.equal(got[k], saved[k]), k
    finally:
        one.shutdown()
        shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("source", ["cached", "sharded"])
def test_distributed_learner_group_restart_resumes(rt, source):
    """``max_group_restarts=1``: after 3 updates the weights are kept
    (``checkpoint_weights``: the driver's cache, or a sharded save), then
    rank 1 is SIGKILLed as the next update starts, with rank 0 inside
    its collective.  The gang is rebuilt, the learner re-materialised
    from the kept weights (the cache re-broadcast, or the committed
    checkpoint read on every rank), and the update retried: the three
    updates from there equal a fresh learner's from the kept weights
    (its Adam state new, as the rebuilt ranks' is) within
    ``LEARNER_RTOL``.  A rebuild from the factory's weights would be
    the first updates' losses instead."""
    from ray_tpu_torch import get as rt_get
    from ray_tpu_torch._private import chaos
    from ray_tpu_torch.rllib.core.learner import (
        DistributedLearnerGroup, metrics_to_host)

    rng = np.random.default_rng(1)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.float32)
    root = tempfile.mkdtemp(prefix="rttp_dlg_restart_") \
        if source == "sharded" else None
    lg = DistributedLearnerGroup(_make_learner, num_hosts=2,
                                 max_group_restarts=1,
                                 checkpoint_root=root)
    try:
        first = [lg.update({"x": x, "y": y})["total_loss"]
                 for _ in range(3)]
        lg.checkpoint_weights()
        kept = lg.get_weights()
        rt_get([w.setup_env.remote({chaos.KILL_SCHEDULE_ENV:
                                    "mesh_run:1:1:0"})
                for w in lg.group.workers], timeout=T)
        after = [lg.update({"x": x, "y": y})["total_loss"]
                 for _ in range(3)]
        assert lg.group.restart_count == 1
        w0, w1 = lg.group.run_stateful(_rank_weights, timeout=T)
    finally:
        lg.shutdown()
        if root is not None:
            shutil.rmtree(root, ignore_errors=True)
    fresh = _make_learner()
    fresh.set_weights(kept)
    want = [metrics_to_host(fresh.update({"x": x, "y": y}))["total_loss"]
            for _ in range(3)]
    np.testing.assert_allclose(after, want, rtol=LEARNER_RTOL)
    assert abs(after[0] - first[0]) > 1e3 * LEARNER_RTOL * abs(first[0])
    for k in w0:
        assert torch.equal(w0[k], w1[k]), k


def test_distributed_learner_group_pipelined_matches_lockstep(rt):
    """``pipeline_depth=2``: six ``update_async`` calls with an async
    sharded save after the third, ``flush_updates`` as the barrier.
    The last metrics and the weights are the lockstep group's bits on
    the same batches (one program, only the driver's waits differ), and
    the save committed the lockstep group's weights after three
    updates."""
    import ray_tpu_torch.checkpoint as tckpt
    from ray_tpu_torch.rllib.core.learner import DistributedLearnerGroup

    rng = np.random.default_rng(2)
    batches = []
    for _ in range(6):
        x = rng.normal(size=(16, 4)).astype(np.float32)
        batches.append({"x": x, "y": (x.sum(axis=1) > 0).astype(
            np.float32)})
    root = tempfile.mkdtemp(prefix="rttp_dlg_pipe_")
    lock = DistributedLearnerGroup(_make_learner, num_hosts=2)
    try:
        want, at_three = [], None
        for i, b in enumerate(batches):
            want.append(lock.update(b)["total_loss"])
            if i == 2:
                at_three = lock.get_weights()
        want_w = lock.get_weights()
    finally:
        lock.shutdown()
    pipe = DistributedLearnerGroup(_make_learner, num_hosts=2,
                                   pipeline_depth=2, metrics_interval=1,
                                   checkpoint_root=root)
    try:
        for i, b in enumerate(batches):
            pipe.update_async(b)
            if i == 2:
                pipe.checkpoint_weights_async()
        last = pipe.flush_updates()
        got_w = pipe.get_weights()
        saved = tckpt.restore_tree(root, step=1)
    finally:
        pipe.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    assert last["total_loss"] == want[-1]
    for k in want_w:
        assert torch.equal(got_w[k], want_w[k]), k
        assert np.asarray(saved[k]).tobytes() == \
            at_three[k].numpy().tobytes(), k
