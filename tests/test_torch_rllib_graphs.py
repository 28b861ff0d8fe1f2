"""The CUDA graphs of the Anakin steps on the card: BC's and MARWIL's
minibatch pass, ES's generation, the bandits' rounds, Dyna-Q's and
QMIX's updates (``CapturedCalls``, ``AnakinUpdates``) and the minibatch
updates of PPO (feedforward, LSTM, attention) and MAPPO
(``MinibatchGraphs``), each against the same iterations run eagerly from
the same seed: the same draws, the same kernels, so the same metrics and
states.

A CUDA graph exists only on a card, so these tests carry the ``cuda``
marker and skip without one.  The file imports no JAX:
``python -m pytest tests/test_torch_rllib_graphs.py -m cuda -q``."""
import numpy as np
import pytest
import torch

# chip_smoke's GRAPH_EAGER_RTOL: the same kernels, unless cuBLAS picks
# another algorithm in capture.
GRAPH_EAGER_RTOL = 1e-5
ITERS = 6  # 3 eager warm-ups, the capture, two replays

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _offline_data(tmp_path):
    from ray_tpu_torch.rllib.offline import JsonWriter
    from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch

    path = tmp_path / "data"
    if path.exists():  # written once: JsonWriter appends
        return str(path)
    rng = np.random.default_rng(0)
    w = JsonWriter(str(path))
    w.write(SampleBatch({
        "obs": rng.normal(size=(512, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, 512),
        "rewards": rng.random(512).astype(np.float32),
        "dones": (rng.random(512) < 0.05).astype(np.float32)}))
    w.close()
    return str(tmp_path / "data")


def _build(name, tmp_path):
    from ray_tpu_torch import rllib

    cfg = getattr(rllib, f"{name.split('-')[0]}Config")().resources(
        device="cuda")
    cfg.debugging(seed=0)
    if name in ("BC", "MARWIL"):
        cfg.environment("CartPole-v1").offline_data(
            input_=_offline_data(tmp_path))
        cfg.num_sgd_per_iter = 4
    elif name == "ES":
        cfg.environment("CartPole-v1").training(population_size=16,
                                                episode_length=50)
    elif name == "DynaQ":
        cfg.environment("CartPole-v1").anakin(num_envs=16, unroll_length=8)
        cfg.learning_starts, cfg.num_updates_per_iter = 128, 4
    elif name == "QMix":
        cfg.anakin(num_envs=16, unroll_length=8)
        cfg.learning_starts = 128
    elif name == "MAPPO":
        cfg.environment("CoordinationGame-v0").anakin(
            num_envs=8, unroll_length=16).training(sgd_minibatch_size=64)
    elif name.startswith("PPO"):
        model = {"PPO": {}, "PPO-lstm": {"use_lstm": True,
                                         "lstm_cell_size": 32},
                 "PPO-attention": {"use_attention": True,
                                   "attention_dim": 32}}[name]
        cfg = (rllib.PPOConfig().environment(
            "StatelessCartPole-v1" if model else "CartPole-v1")
            .anakin(num_envs=16, unroll_length=16)
            .training(sgd_minibatch_size=64, model=model)
            .resources(device="cuda").debugging(seed=0))
    return cfg.build()


def _graphs(algo):
    return [c for c in (getattr(algo, "_calls", None),
                        getattr(getattr(algo, "_train_step", None),
                                "graphs", None),
                        getattr(getattr(algo, "_anakin_state", None),
                                "updates", None),
                        getattr(getattr(algo, "learner", None),
                                "model_updates", None)) if c is not None]


def _state(algo):
    module = getattr(algo, "module", None)
    out = list(module.state_dict().values()) if module is not None else []
    for name in ("flat", "ma_adv_norm"):
        if hasattr(algo, name):
            out.append(getattr(algo, name))
    st = getattr(algo, "_anakin_state", None)
    for name in ("A_inv", "b"):
        if hasattr(st, name):
            out.append(getattr(st, name))
    learner = getattr(algo, "learner", None)
    if learner is not None:
        out += list(learner.checkpoint_state().values())
    return [t.detach().clone() for t in out]


@pytest.mark.parametrize("name", ["BC", "MARWIL", "ES", "BanditLinUCB",
                                  "BanditLinTS", "DynaQ", "QMix", "MAPPO",
                                  "PPO", "PPO-lstm", "PPO-attention"])
def test_graphed_iterations_equal_eager_ones(name, tmp_path):
    runs = []
    for graphed in (False, True):
        algo = _build(name, tmp_path)
        for calls in _graphs(algo):
            calls.use_graphs = graphed
        metrics = [algo.train() for _ in range(ITERS)]
        if graphed:
            assert all(c.replays > 0 for c in _graphs(algo)), name
        runs.append((metrics, _state(algo)))
    (m_eager, s_eager), (m_graph, s_graph) = runs
    for a, b in zip(m_eager, m_graph):
        for k, v in a.items():
            if isinstance(v, float) and k != "time_this_iter_s":
                np.testing.assert_allclose(b[k], v, rtol=GRAPH_EAGER_RTOL,
                                           atol=1e-6, err_msg=k)
    for e, g in zip(s_eager, s_graph):
        scale = max(e.abs().max().item(), 1e-12)
        assert (e - g).abs().max().item() <= GRAPH_EAGER_RTOL * scale, name
