"""The port's recurrent (LSTM) and attention (GTrXL) PPO against the JAX
package's, on the CPU in fp32.

The flax modules are initialised from a seed and their params carried
across with ``recurrent_actor_critic_from_flax`` and
``attention_actor_critic_from_flax``; the same inputs (numpy, from a
seed) go through both: a sequence with resets for the LSTM, windows with
invalid slots for the attention (flat and MinAtar frames).  One test pins
each convention where flax and torch differ: the LSTM's gate order and
carry order, LayerNorm's epsilon, the tanh GELU and the masked score.
Then the port's own invariants (the training replay equals the rollout,
invalid slots change nothing), a pixel attention iteration with
``evaluate``, the reference's refusals, and both policies learn
StatelessCartPole, as ``tests/test_ppo_rnn.py`` and
``tests/test_ppo_attn.py`` ask of the JAX package.

Tolerance: |port - jax| <= ATOL + RTOL * |jax|; the two packages take the
same fp32 sums in other orders (~1e-7 relative)."""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn
import jax
import jax.numpy as jnp

from ray_tpu.rllib.algorithms.ppo_attn import (
    AttentionActorCritic as JAttention,
)
from ray_tpu.rllib.algorithms.ppo_rnn import (
    RecurrentActorCritic as JRecurrent,
)
from ray_tpu.rllib.algorithms.ppo_rnn import zero_carry as jzero_carry
from ray_tpu_torch.models.convert import (
    attention_actor_critic_from_flax,
    recurrent_actor_critic_from_flax,
)
from ray_tpu_torch.rllib import PPOConfig
from ray_tpu_torch.rllib.algorithms import ppo_attn, ppo_rnn

ATOL = RTOL = 1e-5

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tiny tensors gain nothing from more,
    and under the suite's parallel workers extra threads only contend for
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


# ---- the LSTM policy ---------------------------------------------------------

def _recurrent(obs_dim=3, actions=2, hiddens=(32,), size=16, seed=0):
    jm = JRecurrent(num_actions=actions, hiddens=hiddens, lstm_size=size)
    n = 5
    params = jm.init(jax.random.PRNGKey(seed), jzero_carry(n, size),
                     jnp.zeros((n, obs_dim)), jnp.zeros(n, bool))
    tm = ppo_rnn.RecurrentActorCritic(actions, obs_dim, hiddens, size)
    tm.load_state_dict(recurrent_actor_critic_from_flax(_np(params)),
                       strict=True)
    return jm, params, tm


def test_recurrent_module_matches_flax_over_a_sequence_with_resets():
    jm, params, tm = _recurrent()
    rng = np.random.default_rng(0)
    T, n = 12, 5
    obs = rng.normal(size=(T, n, 3)).astype(np.float32)
    resets = rng.random((T, n)) < 0.2
    resets[0] = True
    resets[5, 0] = True
    jc = jzero_carry(n, 16)
    tc = ppo_rnn.zero_carry(n, 16)
    for t in range(T):
        jc, jlogits, jvalue = jm.apply(params, jc, jnp.asarray(obs[t]),
                                       jnp.asarray(resets[t]))
        tc, logits, value = tm(tc, torch.from_numpy(obs[t]),
                               torch.from_numpy(resets[t]))
        _close(logits, jlogits)
        _close(value, jvalue)
        for tsub, jsub in zip(tc, jc):
            for x, y in zip(tsub, jsub):
                _close(x, y)
    # The replay of the whole sequence from the first carry: the same.
    logits, value = tm.sequence(ppo_rnn.zero_carry(n, 16),
                                torch.from_numpy(obs),
                                torch.from_numpy(resets))
    _close(logits[-1], jlogits)
    _close(value[-1], jvalue)


def test_lstm_gate_order_and_carry_order_are_flax_s():
    """flax's OptimizedLSTMCell keeps eight Dense layers (ii if ig io
    without bias, hi hf hg ho with); torch packs i, f, g, o in its two
    matrices.  With every gate's weights distinct, the converted cell
    agrees with flax's and a cell with two gates swapped does not.  flax
    returns the carry (c, h), torch (h, c): the port's carry is flax's
    (c first), and c differs from h."""
    size, d = 8, 6
    cell = fnn.OptimizedLSTMCell(size)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(4, d)).astype(np.float32))
    c0 = jnp.asarray(rng.normal(size=(4, size)).astype(np.float32))
    h0 = jnp.asarray(rng.normal(size=(4, size)).astype(np.float32))
    params = cell.init(jax.random.PRNGKey(2), (c0, h0), x)
    # Non-zero biases, so that their place is checked too.
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.3 if path[-1].key == "bias" else v, params)
    (jc, jh), _ = cell.apply(params, (c0, h0), x)
    sd = recurrent_actor_critic_from_flax(
        {"lstm_pi": _np(params["params"])})
    tcell = torch.nn.LSTMCell(d, size)
    tcell.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    args = (torch.from_numpy(np.array(x)),
            (torch.from_numpy(np.array(h0)), torch.from_numpy(np.array(c0))))
    h, c = tcell(*args)
    _close(c, jc)
    _close(h, jh)
    assert np.abs(np.asarray(jc) - np.asarray(jh)).max() > 0.1
    swapped = {k: v.view(4, size, -1)[[0, 2, 1, 3]].reshape(v.shape)
               if v.dim() else v for k, v in tcell.state_dict().items()}
    tcell.load_state_dict(swapped)
    h2, _ = tcell(*args)
    assert (h2 - h).abs().max() > 1e-2
    # The module's carry is (c, h), as flax's.
    jm, mparams, tm = _recurrent()
    obs = jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32))
    (jpi, _), _, _ = jm.apply(mparams, jzero_carry(5, 16), obs,
                              jnp.zeros(5, bool))
    (pi, _), _, _ = tm(ppo_rnn.zero_carry(5, 16),
                       torch.from_numpy(np.array(obs)),
                       torch.zeros(5, dtype=torch.bool))
    _close(pi[0], jpi[0])
    _close(pi[1], jpi[1])


def test_lstm_init_is_flax_s():
    """Input kernels lecun_normal (variance 1 / fan_in), recurrent kernels
    orthogonal, biases zero: no +1 on the forget gate."""
    cell = ppo_rnn.lstm_cell(64, 32, torch.Generator().manual_seed(0))
    assert cell.bias_ih.abs().max() == 0 and cell.bias_hh.abs().max() == 0
    for gate in cell.weight_hh.view(4, 32, 32):
        np.testing.assert_allclose((gate @ gate.T).detach().numpy(),
                                   np.eye(32), atol=1e-5)
    var = cell.weight_ih.detach().var().item()
    assert abs(var * 64 - 1.0) < 0.1


# ---- the attention policy ------------------------------------------------------

def _attention(obs_dims=(2,), actions=3, window=4, d=32, heads=2, layers=1,
               seed=0, pixels=False):
    jm = JAttention(num_actions=actions, window=window, d_model=d,
                    heads=heads, layers=layers,
                    obs_shape=obs_dims if pixels else None)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((2, window) + obs_dims),
                     jnp.ones((2, window), bool))
    tm = ppo_attn.AttentionActorCritic(
        actions, window, None if pixels else obs_dims[0], d, heads, layers,
        obs_shape=obs_dims if pixels else None)
    tm.load_state_dict(attention_actor_critic_from_flax(_np(params)),
                       strict=True)
    return jm, params, tm


def _windows(rng, b, window, obs_dims, pixels=False):
    if pixels:
        hist = (rng.random((b, window) + obs_dims) < 0.3).astype(np.float32)
    else:
        hist = rng.normal(size=(b, window) + obs_dims).astype(np.float32)
    # Valid slots are a suffix of the window (the episode's steps so
    # far); row 0 is all valid, row 1 only the current slot.
    start = rng.integers(0, window, b)
    start[0], start[1] = 0, window - 1
    valid = np.arange(window)[None, :] >= start[:, None]
    return hist, valid


@pytest.mark.parametrize("pixels", [False, True], ids=["flat", "minatar"])
def test_attention_module_matches_flax(pixels):
    obs_dims = (10, 10, 4) if pixels else (2,)
    jm, params, tm = _attention(obs_dims, layers=2, pixels=pixels)
    hist, valid = _windows(np.random.default_rng(3), 8, 4, obs_dims, pixels)
    jl, jv = jm.apply(params, jnp.asarray(hist), jnp.asarray(valid))
    logits, value = tm(torch.from_numpy(hist), torch.from_numpy(valid))
    _close(logits, jl)
    _close(value, jv)


def test_invalid_slots_do_not_change_the_output():
    """tests/test_ppo_attn.py:27 on the port: garbage in masked slots."""
    _, _, tm = _attention()
    hist = torch.zeros(1, 4, 2)
    hist[:, -1] = torch.tensor([0.3, -0.7])
    garbage = hist.clone()
    garbage[:, 0] = torch.tensor([99.0, -99.0])
    valid = torch.tensor([[False, False, False, True]])
    la, va = tm(hist, valid)
    lb, vb = tm(garbage, valid)
    torch.testing.assert_close(la, lb, rtol=0, atol=1e-6)
    torch.testing.assert_close(va, vb, rtol=0, atol=1e-6)


def test_layer_norm_eps_and_tanh_gelu_are_flax_s():
    """flax's LayerNorm has eps 1e-6 (torch's default 1e-5) and flax's
    gelu is the tanh approximation: on inputs of variance ~1e-6, and
    where the two GELUs differ, the port agrees with flax and the torch
    defaults would not."""
    block = ppo_attn.GTrXLBlock(16, 2)
    assert block.LayerNorm_0.eps == block.LayerNorm_1.eps == 1e-6
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(4, 16)) * 1e-3).astype(np.float32)
    want = fnn.LayerNorm().apply({"params": {"scale": jnp.ones(16),
                                             "bias": jnp.zeros(16)}},
                                 jnp.asarray(x))
    _close(block.LayerNorm_0(torch.from_numpy(x)), want)
    default = torch.nn.LayerNorm(16)(torch.from_numpy(x))
    assert np.abs(default.detach().numpy() - np.asarray(want)).max() > 1e-2
    z = np.linspace(-4, 4, 81).astype(np.float32)
    _close(F.gelu(torch.from_numpy(z), approximate="tanh"),
           fnn.gelu(jnp.asarray(z)))
    erf = F.gelu(torch.from_numpy(z)).numpy()
    assert np.abs(erf - np.asarray(fnn.gelu(jnp.asarray(z)))).max() > 1e-4


def test_masked_scores_take_the_most_negative_value():
    """A row with every column masked (an invalid slot's row) is uniform
    over the K columns in flax, as the dtype's most negative value makes
    it, where -inf would make it NaN; the port's MHA gives flax's output
    there too."""
    d, heads, window = 16, 2, 4
    mha = fnn.MultiHeadDotProductAttention(num_heads=heads, qkv_features=d)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(2, window, d)).astype(np.float32))
    mask = np.zeros((2, 1, window, window), bool)
    mask[1] = np.tril(np.ones((window, window), bool))
    params = mha.init(jax.random.PRNGKey(0), x, x, mask=jnp.asarray(mask))
    want = mha.apply(params, x, x, mask=jnp.asarray(mask))
    sd = attention_actor_critic_from_flax(
        {"block_pi_0": {"mha": _np(params["params"])}})
    port = ppo_attn.MultiHeadAttention(d, heads)
    port.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()})
    got = port(torch.from_numpy(np.array(x)), torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    _close(got, want)


# ---- the port's training paths ---------------------------------------------

def test_sequence_replay_matches_the_rollout_exactly():
    """tests/test_ppo_rnn.py:30 on the port: the replay from the unroll's
    first carry gives the rollout's log-probabilities."""
    from ray_tpu_torch.rllib.core.rl_module import (
        logp_and_entropy,
        sample_categorical,
    )
    from ray_tpu_torch.rllib.env.torch_envs import (
        CartPole,
        vector_reset,
        vector_step,
    )

    env, n, T = CartPole(), 4, 48
    gen = torch.Generator().manual_seed(0)
    tm = ppo_rnn.RecurrentActorCritic(2, 4, (32,), 16, generator=gen)
    states, obs = vector_reset(env, gen, n, "cpu")
    carry0 = carry = ppo_rnn.zero_carry(n, 16)
    prev_done = torch.zeros(n, dtype=torch.bool)
    obs_l, reset_l, act_l, logp_l = [], [], [], []
    with torch.no_grad():
        for _ in range(T):
            carry, logits, _ = tm(carry, obs, prev_done)
            act, lp = sample_categorical(logits, gen)
            obs_l.append(obs)
            reset_l.append(prev_done)
            act_l.append(act)
            logp_l.append(lp)
            states, obs, _, prev_done, _ = vector_step(env, states, act, gen)
        logits, _ = tm.sequence(carry0, torch.stack(obs_l),
                                torch.stack(reset_l))
    assert torch.stack(reset_l).any()
    replay, _ = logp_and_entropy(logits, torch.stack(act_l))
    torch.testing.assert_close(replay, torch.stack(logp_l), rtol=1e-5,
                               atol=1e-5)


def test_pixel_attention_trains_and_evaluates():
    """tests/test_ppo_attn.py:64 on the port: the MinAtar CNN in every
    window slot, one iteration and a greedy evaluation."""
    algo = (PPOConfig().environment("Breakout-MinAtar-v0")
            .anakin(num_envs=8, unroll_length=8)
            .training(model={"use_attention": True, "attention_window": 4})
            .resources(device="cpu").build())
    m = algo.train()
    assert math.isfinite(m["total_loss"])
    assert m["num_env_steps_sampled_this_iter"] == 64
    out = algo.evaluate(num_steps=60)
    assert math.isfinite(out["episode_reward_mean"])


class _Continuous:
    num_actions = None
    obs_dim = 3


@pytest.mark.parametrize("config,error,match", [
    (lambda: PPOConfig().environment("CartPole-v1").training(
        model={"use_attention": True, "use_lstm": True}), ValueError,
     "exclusive"),
    (lambda: PPOConfig().environment("Breakout-MinAtar-v0").training(
        model={"use_lstm": True}), ValueError, "flat-observation"),
    (lambda: PPOConfig().environment(_Continuous()).training(
        model={"use_lstm": True}), ValueError, "discrete"),
    (lambda: PPOConfig().environment(_Continuous()).training(
        model={"use_attention": True}), ValueError, "discrete"),
    (lambda: PPOConfig().environment("CartPole-v1").anakin(
        num_envs=10, unroll_length=64).training(
            sgd_minibatch_size=256, model={"use_lstm": True}), ValueError,
     "silently dropped"),
    (lambda: PPOConfig().environment("PendulumContinuous-v1").training(
        model={"use_lstm": True}), ValueError, "SAC family"),
], ids=["exclusive", "pixels", "continuous_lstm", "continuous_attention",
        "dropped_sequences", "pendulum_continuous"])
def test_memory_ppo_refuses_as_the_reference(config, error, match):
    with pytest.raises(error, match=match):
        config().resources(device="cpu").build()


def _learn_stateless_cartpole(model):
    algo = (PPOConfig().environment("StatelessCartPole-v1")
            .anakin(num_envs=64, unroll_length=64)
            .training(lr=3e-4, num_sgd_iter=4, sgd_minibatch_size=1024,
                      entropy_coeff=0.01, model=model)
            .resources(device="cpu").debugging(seed=0).build())
    best = 0.0
    for _ in range(120):
        r = algo.train()["episode_reward_mean"]
        if math.isfinite(r):
            best = max(best, r)
        if best >= 150:
            break
    return algo, best


def test_lstm_ppo_learns_stateless_cartpole():
    """The memory gate of tests/test_ppo_rnn.py:76: a memoryless policy
    plateaus near 30; the LSTM must clear 150 within 120 iterations."""
    algo, best = _learn_stateless_cartpole(
        {"use_lstm": True, "lstm_cell_size": 64})
    assert best >= 150, f"LSTM PPO failed the memory task: best={best}"
    assert math.isfinite(algo.evaluate(num_steps=100)["episode_reward_mean"])


@pytest.mark.slow  # 59 s alone on one CPU thread, ~97 s beside the
# suite's other workers; chip_smoke.py [memory] gates it on the card.
def test_attention_ppo_learns_stateless_cartpole():
    """The memory gate of tests/test_ppo_attn.py:85 (the tuned example
    stateless-cartpole-attention.yaml): >= 150 within 120 iterations."""
    algo, best = _learn_stateless_cartpole(
        {"use_attention": True, "attention_dim": 64, "attention_window": 8})
    assert best >= 150, f"attention PPO failed the memory task: best={best}"
    assert math.isfinite(algo.evaluate(num_steps=100)["episode_reward_mean"])
