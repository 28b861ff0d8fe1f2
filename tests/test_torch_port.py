"""Package-wide rules of the PyTorch/CUDA port.

Purity: ``ray_tpu_torch/``, ``chip_smoke.py`` and ``chip_kernel_ab.py``
import no JAX, flax or optax and nothing of ``ray_tpu`` (the machine with
the card has no JAX).
Device: an entry point called without ``device=`` runs on CUDA, and where
there is no CUDA it raises instead of running on the CPU; the training
helpers take no device and run where the model is."""
import ast
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


def test_entry_points_without_device_raise_when_there_is_no_cuda():
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.serve import LLMEngine, LLMServer, NaiveLM, build_model

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    cpu_model = build_model("gpt2", seed=0, device="cpu")
    calls = [lambda: resolve_device(), lambda: resolve_device("cuda"),
             lambda: build_model("gpt2", seed=0),
             lambda: LLMEngine(cpu_model, start=False),
             lambda: NaiveLM(cpu_model, width=64),
             lambda: LLMServer("gpt2", seed=0),
             lambda: PPOConfig().environment("CartPole-v1").anakin(
                 num_envs=4, unroll_length=4).build(),
             lambda: PPOConfig().resources(device="cuda").build()]
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
