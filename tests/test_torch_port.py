"""Package-wide rules of the PyTorch/CUDA port.

Purity: ``ray_tpu_torch/``, ``chip_smoke.py`` and ``chip_kernel_ab.py``
import no JAX, flax or optax and nothing of ``ray_tpu`` (the machine with
the card has no JAX).
Device: an entry point called without ``device=`` runs on CUDA, and where
there is no CUDA it raises instead of running on the CPU; the training
helpers take no device and run where the model is."""
import ast
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")


def _port_sources():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_kernel_ab.py"]
    return files


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_ray_tpu(path):
    assert path.exists(), path
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# A module of the JAX package named in a string: ``ray_tpu.`` with no word
# character or dot before it (``ray_tpu_torch.`` does not match).
_JAX_MODULE_IN_STRING = re.compile(r"(?<![\w.])ray_tpu\.[A-Za-z_]")


def _docstrings(tree):
    return {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)
            and isinstance(node.body[0].value.value, str)}


def _strings_naming_jax_modules(source: str, filename: str = "<string>"):
    tree = ast.parse(source, filename)
    docs = _docstrings(tree)
    return [(node.lineno, node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs
            and _JAX_MODULE_IN_STRING.search(node.value)]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_strings_name_no_module_of_the_jax_package(path):
    """A module path in a string is no import, so the AST walk above cannot
    see it: a worker command ``-m ray_tpu._private.default_worker`` would
    start the JAX package's worker.  Docstrings may name the source."""
    bad = _strings_naming_jax_modules(path.read_text(), str(path))
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


def test_string_check_finds_a_copied_worker_command():
    src = ('"""Names ray_tpu._private.raylet, its source."""\n'
           'CMD = ["-m", "ray_tpu._private.default_worker"]\n'
           'OK = ["-m", "ray_tpu_torch._private.default_worker"]\n'
           'MSG = f"{1} ray_tpu.init() was not called"\n')
    assert [line for line, _ in _strings_naming_jax_modules(src)] == [2, 4]


def test_entry_points_without_device_raise_when_there_is_no_cuda():
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.rllib import APPOConfig, IMPALAConfig, PPOConfig
    from ray_tpu_torch.serve import LLMEngine, LLMServer, NaiveLM, build_model
    from ray_tpu_torch.train import TorchPredictor

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    cpu_model = build_model("gpt2", seed=0, device="cpu")
    calls = [lambda: resolve_device(), lambda: resolve_device("cuda"),
             lambda: build_model("gpt2", seed=0),
             lambda: LLMEngine(cpu_model, start=False),
             lambda: NaiveLM(cpu_model, width=64),
             lambda: LLMServer("gpt2", seed=0),
             lambda: TorchPredictor(torch.nn.Linear(2, 2)),
             lambda: PPOConfig().environment("CartPole-v1").anakin(
                 num_envs=4, unroll_length=4).build(),
             lambda: PPOConfig().resources(device="cuda").build(),
             lambda: IMPALAConfig().environment("CartPole-v1").anakin(
                 num_envs=4, unroll_length=4).build(),
             lambda: APPOConfig().environment("CartPole-v1").anakin(
                 num_envs=4, unroll_length=4).build(),
             lambda: PPOConfig().environment("StatelessCartPole-v1").anakin(
                 num_envs=4, unroll_length=4).training(
                     model={"use_lstm": True}).build()]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_training_helpers_run_where_the_model_is():
    """adamw and make_train_step pick no device: the model comes from
    build_model (CUDA unless told otherwise), and a step on a CPU model
    returns its loss on the CPU, a 0-d tensor that needs no host sync."""
    from ray_tpu_torch.models import gpt2_loss_fn
    from ray_tpu_torch.serve import build_model
    from ray_tpu_torch.train import adamw, make_train_step

    model = build_model("gpt2", seed=0, device="cpu")
    step = make_train_step(model, adamw(model.parameters()), gpt2_loss_fn)
    ids = torch.randint(0, model.config.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(0))
    loss = step({"input_ids": ids})
    assert loss.device.type == "cpu" and loss.dim() == 0
    assert not loss.requires_grad


def test_engine_refuses_a_model_on_another_device():
    from ray_tpu_torch.serve import LLMEngine, build_model

    model = build_model("gpt2", seed=0, device="cpu")
    with pytest.raises(ValueError, match="model is on"):
        LLMEngine(model, device="meta", start=False)


@pytest.mark.parametrize("call,match", [
    (lambda rl: rl.IMPALAConfig().rollouts(num_rollout_workers=2)
     .resources(num_devices=2), "num_devices.*Queue 1 item 6"),
    (lambda rl: rl.APPOConfig().rollouts(num_rollout_workers=2)
     .resources(num_devices=2), "num_devices.*Queue 1 item 6"),
    (lambda rl: rl.PPOConfig().environment("PendulumContinuous-v1"),
     "categorical.*SAC, TD3 or DDPG"),
], ids=["impala_actor_mode", "appo_actor_mode", "pendulum_continuous"])
def test_later_slices_raise_naming_them(call, match):
    from ray_tpu_torch import rllib

    with pytest.raises(NotImplementedError, match=match):
        call(rllib).resources(device="cpu").build()


# An environment name of the JAX package in a string: ``RAY_TPU_`` not
# followed by ``TORCH_``, or ``RTPU_`` (the port's are ``RAY_TPU_TORCH_``
# and ``RTTP_``).
_JAX_ENV_NAME = re.compile(r"RAY_TPU_(?!TORCH_)|RTPU_")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_reads_only_its_own_environment_names(path):
    """A knob set for one package's cluster must not configure the
    other's: the port reads ``RAY_TPU_TORCH_*`` and ``RTTP_*`` names
    only, docstrings and comments included."""
    bad = [(n, line.strip()) for n, line in
           enumerate(path.read_text().splitlines(), 1)
           if _JAX_ENV_NAME.search(line)]
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


def test_each_packages_knob_leaves_the_others_config(monkeypatch):
    from ray_tpu._private.config import CONFIG as jax_config
    from ray_tpu_torch._private.config import CONFIG as port_config

    def read():
        jax_config.reset()
        port_config.reset()
        return jax_config.zero_sharding, port_config.zero_sharding

    try:
        assert read() == ("off", "off")
        monkeypatch.setenv("RAY_TPU_ZERO_SHARDING", "opt+grads")
        assert read() == ("opt+grads", "off")
        monkeypatch.delenv("RAY_TPU_ZERO_SHARDING")
        monkeypatch.setenv("RAY_TPU_TORCH_ZERO_SHARDING", "opt")
        assert read() == ("off", "opt")
    finally:
        monkeypatch.undo()
        read()


def test_chip_smokes_remote_code_pickles_by_value():
    """``python3 chip_smoke.py`` runs the script as ``__main__``, so
    cloudpickle ships its actor classes and task functions to the
    workers by value, with every global they name: a module object
    that cannot be pickled (``torch.backends``'s) fails the phase."""
    import cloudpickle

    import chip_smoke

    cloudpickle.register_pickle_by_value(chip_smoke)
    try:
        for obj in (chip_smoke.GPUActor, chip_smoke.TrainActor,
                    chip_smoke.cpu_task_view, chip_smoke.train_steps,
                    chip_smoke.trainer_loop, chip_smoke.FlashServer,
                    chip_smoke.dp2_loop, chip_smoke.learner_factory,
                    chip_smoke.resnet_loop, chip_smoke.resnet_model,
                    chip_smoke.layouts_loop,
                    chip_smoke.learner_weights,
                    *chip_smoke.elastic_problem()):
            assert cloudpickle.loads(cloudpickle.dumps(obj)).__name__ == \
                obj.__name__
    finally:
        cloudpickle.unregister_pickle_by_value(chip_smoke)
