"""The port's Train stack against the JAX package's.

The scenarios of ``tests/test_train.py`` (the backend executor, the
elastic range, reports, checkpointing, a worker-failure retry) run
through ``ray_tpu`` and through ``ray_tpu_torch``, one module-scoped
cluster at a time, and must give the same results.  Then the port's own
part: a one-worker ``TorchTrainer`` on the tiny GPT-2 with weights
converted from flax, its batches through ``get_dataset_shard`` ->
``iter_device_batches``, against the port's direct step on the same
batches (bit for bit: torch on one thread in both processes) and a
one-worker ``JaxTrainer`` running ``bench.py``'s loop on the same weights
and batches (``test_torch_train.py``'s loss tolerance); a two-worker gloo
process group; and the GPU a ``ScalingConfig()`` asks for by default,
refused at ``fit()`` where there is none.  Every ``get`` has a timeout."""
import importlib

import numpy as np
import pytest
import torch

T = 60  # seconds: the bound of every get

PACKAGES = ("ray_tpu", "ray_tpu_torch")

# test_torch_train.py's fp32 loss tolerance (the same sums in other
# orders).
LOSS_RTOL = 1e-6
B, S, ITERS = 4, 32, 3


@pytest.fixture(scope="module", autouse=True)
def one_thread_and_loops_by_value():
    """Torch on one intra-op thread; the training loops below ship to the
    workers by value (the workers cannot import this test module)."""
    import sys

    import cloudpickle

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    yield
    cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=PACKAGES)
def rt(request):
    """The port's cluster holds no GPU, on a host with a card as well."""
    pkg = importlib.import_module(request.param)
    kw = {"num_gpus": 0} if request.param == "ray_tpu_torch" else {}
    pkg.init(num_cpus=4, object_store_memory=256 * 1024**2, **kw)
    yield pkg
    pkg.shutdown()


port_only = pytest.mark.parametrize("rt", ["ray_tpu_torch"], indirect=True)


def _stack(rt):
    air = importlib.import_module(f"{rt.__name__}.air")
    train = importlib.import_module(f"{rt.__name__}.train")
    return air, train


def _scaling(rt, **kw):
    """The JAX package's ScalingConfig asks for no chip by default; the
    port's asks for a GPU, and these CPU runs ask for none."""
    air, _ = _stack(rt)
    if rt.__name__ == "ray_tpu_torch":
        kw.setdefault("use_gpu", False)
    return air.ScalingConfig(**kw)


def test_backend_executor_basic(rt):
    air, train = _stack(rt)
    session = air.session
    ex = train.BackendExecutor(train.TestConfig(), _scaling(rt, num_workers=2))
    ex.start()

    def loop(config):
        session.report({"rank": session.get_world_rank(),
                        "world": session.get_world_size()})

    try:
        ex.start_training(loop, {})
        results = ex.get_next_results(timeout=T)
        assert sorted(r[1]["rank"] for r in results) == [0, 1]
        assert all(r[1]["world"] == 2 for r in results)
        assert ex.get_next_results(timeout=T) is None
    finally:
        ex.shutdown()


def test_scaling_config_elastic_range(rt):
    air, _ = _stack(rt)
    assert air.ScalingConfig(num_workers=3).worker_range() == (3, 3)
    sc = air.ScalingConfig(num_workers=(1, 4))
    assert sc.min_workers == 1 and sc.max_workers == 4
    with pytest.raises(ValueError):
        air.ScalingConfig(num_workers=(3, 2)).worker_range()
    with pytest.raises(ValueError):
        air.ScalingConfig(num_workers=0).worker_range()


def test_backend_executor_elastic_range(rt):
    """num_workers=(min, max): start() probes max->min and takes the
    largest gang the cluster can place now (3 of the 4 CPUs)."""
    air, train = _stack(rt)
    session = air.session
    ex = train.BackendExecutor(train.TestConfig(),
                               _scaling(rt, num_workers=(1, 3)))
    ex.start()

    def loop(config):
        session.report({"world": session.get_world_size()})

    try:
        assert ex.num_workers == 3
        ex.start_training(loop, {})
        results = ex.get_next_results(timeout=T)
        assert [r[1]["world"] for r in results] == [3, 3, 3]
        assert ex.get_next_results(timeout=T) is None
    finally:
        ex.shutdown()


def test_data_parallel_trainer_reports(rt):
    air, train = _stack(rt)
    session = air.session

    def loop(config):
        for step in range(3):
            session.report({"step": step, "loss": 1.0 / (step + 1)})

    result = train.DataParallelTrainer(
        loop, backend_config=train.TestConfig(),
        scaling_config=_scaling(rt, num_workers=2)).fit()
    assert result.error is None
    assert result.metrics == {"step": 2, "loss": 1.0 / 3}
    assert [m["step"] for m in result.metrics_history] == [0, 1, 2]


def test_trainer_checkpointing(rt, tmp_path):
    """Reported checkpoints: the last one comes back, the manager keeps
    two (with a storage path, as committed steps on disk), and a trainer
    resumed from it starts after its step."""
    air, train = _stack(rt)
    session, Checkpoint = air.session, air.Checkpoint

    def loop(config):
        ckpt = session.get_checkpoint()
        start = ckpt.to_dict()["step"] + 1 if ckpt else 0
        for step in range(start, config["steps"]):
            session.report({"step": step},
                           checkpoint=Checkpoint.from_dict({"step": step}))

    def trainer(steps, **kw):
        return train.DataParallelTrainer(
            loop, train_loop_config={"steps": steps},
            backend_config=train.TestConfig(),
            scaling_config=_scaling(rt, num_workers=1), **kw)

    result = trainer(3, run_config=air.RunConfig(
        storage_path=str(tmp_path),
        checkpoint_config=air.CheckpointConfig(num_to_keep=2))).fit()
    assert result.error is None
    assert result.checkpoint.to_dict()["step"] == 2
    steps = sorted(p.name for p in (tmp_path / "steps").iterdir())
    assert steps == ["step_00000002", "step_00000003"]
    resumed = trainer(5, resume_from_checkpoint=result.checkpoint).fit()
    assert resumed.error is None
    assert [m["step"] for m in resumed.metrics_history] == [3, 4]


def test_trainer_worker_failure_retry(rt, tmp_path):
    air, train = _stack(rt)
    session, Checkpoint = air.session, air.Checkpoint
    marker = str(tmp_path / "failed_once")

    def loop(config):
        import os

        if not os.path.exists(marker):
            open(marker, "w").close()
            raise RuntimeError("simulated failure")
        session.report({"ok": 1}, checkpoint=Checkpoint.from_dict({"ok": 1}))

    result = train.DataParallelTrainer(
        loop, backend_config=train.TestConfig(),
        scaling_config=_scaling(rt, num_workers=1),
        run_config=air.RunConfig(
            failure_config=air.FailureConfig(max_failures=2))).fit()
    assert result.error is None
    assert result.metrics["ok"] == 1


def test_trainer_without_retries_returns_the_error(rt):
    air, train = _stack(rt)

    def loop(config):
        raise ValueError("bad loop")

    result = train.DataParallelTrainer(
        loop, backend_config=train.TestConfig(),
        scaling_config=_scaling(rt, num_workers=1)).fit()
    assert type(result.error).__name__ == "TrainingWorkerError"
    assert "bad loop" in str(result.error)


# ---------------------------------------------------------------------------
# GPT-2 through the trainers, the process group, the GPU request
# ---------------------------------------------------------------------------
def _jax_params():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import GPT2, GPT2Config

    params = GPT2(GPT2Config.tiny(dtype=jnp.float32)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _tokens():
    """bench.py's synthetic token shard at the tiny shape: int32 ids,
    B * (ITERS + 2) rows (warm-up, timed steps, one spare)."""
    return np.random.default_rng(0).integers(
        0, 512, size=(B * (ITERS + 2), S), dtype=np.int32)


def _port_model(state):
    from ray_tpu_torch.models import GPT2, GPT2Config

    model = GPT2(GPT2Config.tiny(dtype=torch.float32))
    model.load_state_dict(state, strict=True)
    return model


def _port_loop(config):
    """bench.py's gpt2_train_loop in the port, at the tiny fp32 shape on
    the CPU: one warm-up step and ITERS steps, each on the next batch of
    the shard; reports every loss."""
    import torch

    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import GPT2, GPT2Config, gpt2_loss_fn
    from ray_tpu_torch.train.torch import adamw, make_train_step, \
        prepare_model

    torch.set_num_threads(1)
    model = GPT2(GPT2Config.tiny(dtype=torch.float32))
    model.load_state_dict(config["state"], strict=True)
    model = prepare_model(model)
    step = make_train_step(model, adamw(model.parameters(), 3e-4),
                           gpt2_loss_fn)
    batches = session.get_dataset_shard("train").iter_device_batches(
        config["batch"], device="cpu")
    losses = [step({"input_ids": next(batches)["tokens"]}).item()
              for _ in range(config["iters"] + 1)]
    batches.close()
    session.report({"losses": losses, "threads": torch.get_num_threads()})


def _jax_loop(config):
    """The same loop through the JAX package (bench.py's non-ZeRO
    branch): optax.adamw(3e-4) over jax.value_and_grad."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.air import session
    from ray_tpu.models import GPT2, GPT2Config
    from ray_tpu.models.gpt2 import gpt2_loss_fn

    model = GPT2(GPT2Config.tiny(dtype=jnp.float32))
    params = jax.tree_util.tree_map(jnp.asarray, config["params"])
    tx = optax.adamw(3e-4)
    opt = tx.init(params)

    @jax.jit
    def step(params, opt, ids):
        loss, grads = jax.value_and_grad(gpt2_loss_fn)(
            params, model.apply, {"input_ids": ids})
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt, loss

    batches = session.get_dataset_shard("train").iter_device_batches(
        config["batch"])
    losses = []
    for _ in range(config["iters"] + 1):
        params, opt, loss = step(params, opt, next(batches)["tokens"])
        losses.append(float(loss))
    batches.close()
    session.report({"losses": losses})


def _direct_losses(state, tokens):
    from ray_tpu_torch.models import gpt2_loss_fn
    from ray_tpu_torch.train import adamw, make_train_step

    model = _port_model(state)
    step = make_train_step(model, adamw(model.parameters(), 3e-4),
                           gpt2_loss_fn)
    return [step({"input_ids": torch.from_numpy(tokens[i * B:(i + 1) * B])}
                 ).item() for i in range(ITERS + 1)]


@pytest.fixture(scope="module")
def jax_trainer_losses():
    """JaxTrainer's losses, from the JAX package's own cluster."""
    import ray_tpu
    import ray_tpu.data as rdata
    from ray_tpu.air import ScalingConfig
    from ray_tpu.train import JaxTrainer
    from ray_tpu.train.jax import JaxConfig

    ray_tpu.init(num_cpus=4, object_store_memory=256 * 1024**2)
    try:
        result = JaxTrainer(
            _jax_loop,
            train_loop_config={"batch": B, "iters": ITERS,
                               "params": _jax_params()},
            datasets={"train": rdata.from_numpy({"tokens": _tokens()},
                                                parallelism=4)},
            jax_config=JaxConfig(platform="cpu"),
            scaling_config=ScalingConfig(num_workers=1)).fit()
    finally:
        ray_tpu.shutdown()
    assert result.error is None, result.error
    return result.metrics["losses"]


@port_only
def test_torch_trainer_gives_the_direct_step_and_jax_trainer_losses(
        rt, jax_trainer_losses):
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.models.convert import gpt2_params_from_jax
    from ray_tpu_torch.train import TorchTrainer

    state = gpt2_params_from_jax(_jax_params())
    tokens = _tokens()
    result = TorchTrainer(
        _port_loop,
        train_loop_config={"batch": B, "iters": ITERS, "state": state},
        datasets={"train": rdata.from_numpy({"tokens": tokens},
                                            parallelism=4)},
        scaling_config=_scaling(rt, num_workers=1)).fit()
    assert result.error is None, result.error
    losses = result.metrics["losses"]
    assert result.metrics["threads"] == 1
    assert len(losses) == ITERS + 1
    assert losses == _direct_losses(state, tokens)
    np.testing.assert_allclose(losses, jax_trainer_losses, rtol=LOSS_RTOL)


@port_only
def test_two_workers_form_a_gloo_process_group(rt):
    """TorchConfig's rendezvous: worker 0's address, one gloo group of two
    ranks (an all-reduce across it), destroyed when the gang ends;
    ``prepare_model`` across the two wraps the model in
    ``DistributedDataParallel`` over that group, with rank 0's
    parameters on both ranks."""
    from ray_tpu_torch.air import session
    from ray_tpu_torch.train import TorchTrainer

    def loop(config):
        import torch
        import torch.distributed as dist

        from ray_tpu_torch.train.torch import prepare_model

        t = torch.tensor([float(session.get_world_rank() + 1)])
        dist.all_reduce(t)
        torch.manual_seed(session.get_world_rank())
        wrapped = prepare_model(torch.nn.Linear(2, 2))
        w = wrapped.module.weight.detach().clone()
        ws = [torch.empty_like(w) for _ in range(dist.get_world_size())]
        dist.all_gather(ws, w)
        session.report({"rank": dist.get_rank(),
                        "world": dist.get_world_size(),
                        "backend": dist.get_backend(), "sum": t.item(),
                        "wrap": type(wrapped).__name__,
                        "same_weights": torch.equal(ws[0], ws[1])})

    result = TorchTrainer(loop, scaling_config=_scaling(
        rt, num_workers=2)).fit()
    assert result.error is None, result.error
    m = result.metrics
    assert (m["rank"], m["world"], m["backend"], m["sum"]) == \
        (0, 2, "gloo", 3.0)
    assert m["wrap"] == "DistributedDataParallel" and m["same_weights"]


@port_only
def test_default_scaling_asks_for_a_gpu_and_fit_names_cuda(rt):
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train import TorchTrainer

    assert ScalingConfig().worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    assert rt.cluster_resources().get("GPU", 0) == 0

    def loop(config):
        pass

    with pytest.raises(RuntimeError, match="CUDA"):
        TorchTrainer(loop).fit()
