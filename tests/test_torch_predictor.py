"""The port's predictors against the JAX package's
(``ray_tpu_torch/train/predictor.py`` vs ``ray_tpu/train/predictor.py``),
the counterpart of ``tests/test_data_formats.py::
test_batch_predictor_over_dataset``.

The same weights go into a JAX checkpoint (``Checkpoint.from_pytree``)
and a port checkpoint (``Checkpoint.from_state_dict``, converted where
the layouts differ); ``JaxPredictor`` runs in this process and the port's
``BatchPredictor`` maps ``TorchPredictor`` over a Dataset's blocks in
the workers of one port cluster (``device="cpu"``)."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.air import Checkpoint as JCheckpoint
from ray_tpu.models.resnet import ResNet as JResNet
from ray_tpu.models.resnet import ResNetConfig as JConfig
from ray_tpu.train import JaxPredictor
from ray_tpu_torch import data as rdata
from ray_tpu_torch.air import Checkpoint
from ray_tpu_torch.models import ResNet, ResNetConfig
from ray_tpu_torch.models.convert import resnet_params_from_jax
from ray_tpu_torch.train import BatchPredictor, TorchPredictor

T = 120  # seconds: the bound of every get


class Linear(torch.nn.Module):
    """x @ w, the JAX test's model."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(2, 1))

    def forward(self, x):
        return x @ self.w


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
def cluster():
    import ray_tpu_torch as rt

    rt.init(num_cpus=4, num_gpus=0, object_store_memory=256 * 1024**2)
    try:
        yield
    finally:
        rt.shutdown()


def _predictions(dataset, column="predictions"):
    return np.concatenate([b[column] for b in dataset.iter_batches(
        batch_size=1 << 20)])


def test_batch_predictor_over_dataset_matches_jax_predictor(cluster):
    """x @ w over four blocks: the port's predictions equal
    JaxPredictor's on the same weights and x @ w (JAX's test's bound)."""
    w = np.array([[2.0], [3.0]], dtype=np.float32)
    x = np.random.default_rng(0).normal(size=(64, 2)).astype(np.float32)
    want = JaxPredictor.from_checkpoint(
        JCheckpoint.from_pytree({"params": {"w": w}}),
        apply_fn=lambda p, x: jnp.asarray(x) @ p["w"],
        input_column="x").predict({"x": x})["predictions"]
    bp = BatchPredictor.from_checkpoint(
        Checkpoint.from_state_dict({"w": torch.from_numpy(w)}),
        TorchPredictor, model=Linear, input_column="x", device="cpu")
    got = _predictions(bp.predict(rdata.from_numpy({"x": x},
                                                   parallelism=4)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, x @ w, rtol=1e-5)


def test_resnet_batch_prediction_matches_jax_predictor(cluster):
    """ResNet tiny in eval mode on converted weights and running
    statistics: BatchPredictor(TorchPredictor) over a Dataset equals
    JaxPredictor's logits (fp32, 1e-5 of their scale); keep_columns keeps
    the named column and the predictions."""
    rng = np.random.default_rng(1)
    images = rng.normal(size=(24, 32, 32, 3)).astype(np.float32)
    jmodel = JResNet(JConfig.tiny(dtype=jnp.float32))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images[:1]),
                            train=False)
    variables = jax.tree_util.tree_map(
        lambda a: np.abs(np.asarray(a) + 0.1 * rng.normal(
            size=np.shape(a)).astype(np.float32)), variables)
    want = JaxPredictor(
        variables, lambda v, x: jmodel.apply(v, x, train=False),
        input_column="image").predict({"image": images})["predictions"]
    state = resnet_params_from_jax(variables["params"],
                                   variables["batch_stats"])
    build = functools.partial(ResNet, ResNetConfig.tiny(dtype=torch.float32))
    ckpt = Checkpoint.from_state_dict(state)
    labels = np.arange(24) % 10
    out = BatchPredictor.from_checkpoint(
        ckpt, TorchPredictor, model=build, input_column="image",
        device="cpu").predict(
            rdata.from_numpy({"image": images, "label": labels},
                             parallelism=3), keep_columns=["label"])
    batches = list(out.iter_batches(batch_size=64))
    assert set(batches[0]) == {"label", "predictions"}
    got = np.concatenate([b["predictions"] for b in batches])
    np.testing.assert_array_equal(
        np.concatenate([b["label"] for b in batches]), labels)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    # One process's TorchPredictor on the same checkpoint agrees too.
    local = TorchPredictor.from_checkpoint(ckpt, model=build,
                                           input_column="image",
                                           device="cpu")
    np.testing.assert_allclose(local.predict({"image": images})[
        "predictions"], got, rtol=0, atol=1e-6 * np.abs(got).max())


def test_torch_predictor_runs_on_cuda_unless_told_the_cpu():
    """No device means CUDA: without a card it raises instead of running
    on the CPU; a bf16 output comes back as fp32 numpy; one column or an
    input_column is required."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TorchPredictor(Linear())

    class BF16(Linear):
        def forward(self, x):
            return x.to(torch.bfloat16) @ self.w.to(torch.bfloat16)

    p = TorchPredictor(BF16(), device="cpu")
    out = p.predict({"x": np.ones((3, 2), np.float32)})
    with pytest.raises(ValueError, match="input_column"):
        p.predict({"x": np.ones((1, 2)), "y": np.ones(1)})
    assert out["predictions"].dtype == np.float32


def test_block_tasks_ask_for_the_card_only_on_cuda():
    """A CUDA predictor's block tasks ask for a card, a ``device="cpu"``
    one's for none; ``map_batches`` carries the share in its plan op, and
    a fused block task asks for the largest share of its ops."""
    from ray_tpu_torch.data import execution
    from ray_tpu_torch.data.dataset import Dataset

    ckpt = Checkpoint.from_state_dict(Linear().state_dict())
    for kw, share in (({}, 1), ({"device": "cuda"}, 1),
                      ({"device": "cpu"}, 0)):
        bp = BatchPredictor.from_checkpoint(ckpt, TorchPredictor,
                                            model=Linear, **kw)
        assert bp._num_gpus == share
    ds = Dataset([]).map_batches(len).map_batches(len, num_gpus=0.5)
    assert ds._plan[0] == ("map_batches", len, "numpy")
    assert ds._plan[1] == ("map_batches", len, "numpy", 0.5)

    class Task:
        def options(self, **kw):
            return kw

    assert execution._with_gpus(Task(), ds._plan) == {"num_gpus": 0.5}
    task = Task()
    assert execution._with_gpus(task, ds._plan[:1]) is task
