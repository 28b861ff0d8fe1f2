"""The port's ``rllib train`` / ``rllib evaluate`` CLIs
(``ray_tpu_torch/rllib/train.py``, ``evaluate.py``) and its tuned
examples, against the JAX package's.

- ``run_experiment`` through a JSON experiment file with PyYAML masked
  (the JAX package's loader imports PyYAML first, so its JSON files fail
  without it: the fault the copy repairs), and ``evaluate_checkpoint`` of
  the checkpoint it wrote (an ``air.Checkpoint`` of the module's state
  dict, restored bit for bit);
- a yaml file without PyYAML raises a clear ``ImportError``; the tuned
  examples are the JAX package's files and configure the port's
  algorithms;
- ``python -m ray_tpu_torch.rllib.train`` and ``... .evaluate`` run as
  commands; without ``device: cpu`` an experiment asks for CUDA, which
  this machine lacks."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ray_tpu.rllib import train as jtrain
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.rllib import get_algorithm_config
from ray_tpu_torch.rllib import train as ttrain
from ray_tpu_torch.rllib.evaluate import evaluate_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = "rllib/tuned_examples"
PPO_EXPERIMENT = {"cartpole-ppo": {
    "run": "PPO", "env": "CartPole-v1",
    "stop": {"episode_reward_mean": 500, "training_iteration": 2},
    "config": {"num_envs": 16, "unroll_length": 32, "num_sgd_iter": 1,
               "sgd_minibatch_size": 256, "device": "cpu",
               "model": {"fcnet_hiddens": [32, 32]}}}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_yaml(monkeypatch):
    """PyYAML masked: ``import yaml`` raises ImportError."""
    monkeypatch.setitem(sys.modules, "yaml", None)


def _write_json(tmp_path, experiments) -> str:
    path = tmp_path / "experiments.json"
    path.write_text(json.dumps(experiments))
    return str(path)


def test_json_experiment_runs_without_pyyaml_and_evaluates(tmp_path,
                                                             no_yaml,
                                                             capsys):
    path = _write_json(tmp_path, PPO_EXPERIMENT)
    with pytest.raises(ImportError):  # the JAX package's loader
        jtrain._load_experiments(path)
    ckpt_root = str(tmp_path / "ckpt")
    assert ttrain.main(["-f", path, "--checkpoint-dir", ckpt_root]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    metrics = out["cartpole-ppo"]
    assert metrics["training_iteration"] == 2
    assert metrics["num_env_steps_sampled"] == 2 * 16 * 32
    ckpt = metrics["checkpoint_path"]
    assert ckpt == os.path.join(ckpt_root, "cartpole-ppo")
    saved = Checkpoint.from_directory(ckpt)
    assert saved.extra()["iteration"] == 2
    config = PPO_EXPERIMENT["cartpole-ppo"]["config"]
    cfg = get_algorithm_config("PPO").environment("CartPole-v1")
    algo = ttrain.apply_config(cfg, config).build()
    algo.load_checkpoint(saved)
    for name, v in algo.module.state_dict().items():
        assert torch.equal(v, saved.to_state_dict()[name]), name
    result = evaluate_checkpoint(ckpt, "PPO", "CartPole-v1", config,
                                 num_steps=100)
    assert np.isfinite(result["episode_reward_mean"])


def test_a_yaml_file_without_pyyaml_raises_clearly(tmp_path, no_yaml):
    path = tmp_path / "exp.yaml"
    path.write_text("x:\n  run: PPO\n")
    with pytest.raises(ImportError, match="PyYAML"):
        ttrain._load_experiments(str(path))


def test_tuned_examples_are_the_references_and_configure_the_port():
    import yaml

    ours = sorted(os.listdir(os.path.join(REPO, "ray_tpu_torch", EXAMPLES)))
    theirs = sorted(os.listdir(os.path.join(REPO, "ray_tpu", EXAMPLES)))
    assert ours == theirs and len(ours) == 5
    for name in ours:
        path = os.path.join(REPO, "ray_tpu_torch", EXAMPLES, name)
        with open(path, "rb") as f, open(os.path.join(
                REPO, "ray_tpu", EXAMPLES, name), "rb") as g:
            assert f.read() == g.read(), name
        assert ttrain._load_experiments(path) == jtrain._load_experiments(
            path)
        for exp in ttrain._load_experiments(path).values():
            cfg = get_algorithm_config(exp["run"]).environment(exp["env"])
            ttrain.apply_config(cfg, exp.get("config", {}))
    with pytest.raises(ValueError, match="unknown config key"):
        ttrain.apply_config(get_algorithm_config("PPO"), {"lrr": 1.0})


def test_without_a_cpu_device_an_experiment_asks_for_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.run_experiment("BanditLinUCB", "LinearBandit-v0", {},
                              {"training_iteration": 1}, verbose=False)


def test_train_and_evaluate_run_as_commands(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    ckpt = str(tmp_path / "ckpt")
    config = json.dumps({"device": "cpu", "num_envs": 8,
                         "unroll_length": 16, "num_sgd_iter": 1,
                         "sgd_minibatch_size": 128})

    def command(*args):
        run = subprocess.run([sys.executable, "-m", *args],
                             capture_output=True, text=True, env=env,
                             cwd=str(tmp_path), timeout=300)
        assert run.returncode == 0, run.stderr
        return json.loads(run.stdout.strip().splitlines()[-1])

    metrics = command("ray_tpu_torch.rllib.train", "--algo", "PPO", "--env",
                      "CartPole-v1", "--stop-iters", "1", "--config",
                      config, "--checkpoint-dir", ckpt)
    assert metrics["training_iteration"] == 1
    assert metrics["checkpoint_path"] == ckpt
    out = command("ray_tpu_torch.rllib.evaluate", ckpt, "--algo", "PPO",
                  "--env", "CartPole-v1", "--config", config, "--steps",
                  "50")
    assert np.isfinite(out["episode_reward_mean"])
