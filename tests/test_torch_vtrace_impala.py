"""The port's V-trace, IMPALA and APPO against the JAX package's, on the
CPU in fp32.

``vtrace`` on random time-major inputs with dones and off-policy
log-probabilities; its on-policy case against GAE with lambda = 1; the
IMPALA and APPO losses (values and gradients, converted weights) on
CartPole vectors and Breakout-MinAtar boards; one whole IMPALA update
(loss, clip, Adam) from the same trajectory and weights.  Then the port's
IMPALA and APPO learn CartPole, as ``tests/test_rl_utils.py`` and
``tests/test_more_algos.py`` ask of the JAX package."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.rllib.algorithms import appo as jappo
from ray_tpu.rllib.algorithms import impala as jimpala
from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec
from ray_tpu.rllib.utils.vtrace import vtrace as jvtrace
from ray_tpu_torch.models.convert import actor_critic_from_flax
from ray_tpu_torch.rllib import APPOConfig, IMPALAConfig, RLModuleSpec
from ray_tpu_torch.rllib.algorithms import appo as tappo
from ray_tpu_torch.rllib.algorithms import impala as timpala
from ray_tpu_torch.rllib.evaluation.postprocessing import gae_torch
from ray_tpu_torch.rllib.utils import mesh as tmesh
from ray_tpu_torch.rllib.utils.vtrace import vtrace

# V-trace: the same fp32 recursion in the same order; exp and the
# clipped products may round an ulp apart.
VTRACE_RTOL, VTRACE_ATOL = 1e-5, 1e-6
# The losses: means over T*N of the same fp32 terms; the networks' sums
# (fan-in up to 1600) in other orders, ~1e-7 relative.  Gradients are
# sums over the 512 frames of the batch, held to 1e-5 of each tensor's
# largest magnitude.
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5
# One clip + Adam step of lr 5e-4 from a zero state moves an element by
# lr * g / (|g| + eps), eps = 1e-8: where |g| >> eps the gradients' ~1e-7
# relative differences move it by ~1e-10, held to 1e-6 (0.2% of lr).
# Where |g| is itself near eps (rounding noise of a sum that cancels:
# measured 9e-9 to 2e-8 at the three elements of trunk.dense_0 that
# differ by more, up to 1.7e-6), the step's size and sign are decided by
# that noise, and the two steps are held only to Adam's bound, 2 * lr.
UPDATE_ATOL = 1e-6
NOISE_GRAD = 1e-6  # 100 * eps
COEFFS = dict(gamma=0.99, clip_rho=1.0, clip_c=1.0, vf_loss_coeff=0.5,
              entropy_coeff=0.01)

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tiny tensors gain nothing from more,
    and under the suite's parallel workers extra threads only contend for
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _vtrace_inputs(rng, T=32, N=8):
    behaviour = np.log(rng.uniform(0.05, 1.0, (T, N))).astype(np.float32)
    # Target log-probabilities up to ~1 nat apart: ratios on both sides of
    # the clips.
    target = (behaviour + rng.normal(0, 0.5, (T, N))).astype(np.float32)
    return dict(
        behaviour_logp=behaviour, target_logp=target,
        rewards=rng.normal(size=(T, N)).astype(np.float32),
        values=rng.normal(size=(T, N)).astype(np.float32),
        dones=rng.random((T, N)) < 0.1,
        last_value=rng.normal(size=N).astype(np.float32))


@pytest.mark.parametrize("clip_rho,clip_c", [(1.0, 1.0), (2.0, 0.5)])
def test_vtrace_matches_jax(clip_rho, clip_c):
    x = _vtrace_inputs(np.random.default_rng(0))
    rho = np.exp(x["target_logp"] - x["behaviour_logp"])
    assert (rho > 2.0).any() and (rho < 0.5).any() and x["dones"].any()
    args = ("behaviour_logp", "target_logp", "rewards", "values", "dones",
            "last_value")
    want = jvtrace(*(jnp.asarray(x[k]) for k in args), gamma=0.99,
                   clip_rho=clip_rho, clip_c=clip_c)
    leaves = {k: torch.from_numpy(x[k]) for k in args}
    leaves["target_logp"].requires_grad_()
    got = vtrace(*(leaves[k] for k in args), gamma=0.99, clip_rho=clip_rho,
                 clip_c=clip_c)
    for g, w in zip(got, want):
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=VTRACE_RTOL, atol=VTRACE_ATOL)


def test_vtrace_on_policy_is_gae_lambda_one():
    """Target == behaviour: every ratio is 1, so ``vs`` is GAE(lambda=1)'s
    value target and ``pg_adv`` the one-step TD error against ``vs``; with
    gamma = 1, zero values and unit rewards ``vs`` is the rewards-to-go
    (tests/test_rllib.py:33)."""
    x = _vtrace_inputs(np.random.default_rng(1))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    vs, pg_adv = vtrace(t["behaviour_logp"], t["behaviour_logp"],
                        t["rewards"], t["values"], t["dones"],
                        t["last_value"], gamma=0.99)
    _, targets = gae_torch(t["rewards"], t["values"], t["dones"],
                           t["last_value"], 0.99, 1.0)
    np.testing.assert_allclose(vs.numpy(), targets.numpy(), rtol=1e-5,
                               atol=1e-5)
    nt = 1.0 - t["dones"].float()
    vs_tp1 = torch.cat([vs[1:], t["last_value"][None]])
    np.testing.assert_allclose(
        pg_adv.numpy(), (t["rewards"] + 0.99 * vs_tp1 * nt
                         - t["values"]).numpy(), rtol=1e-6, atol=1e-6)
    T, N = 10, 2
    zeros = torch.zeros(T, N)
    vs, _ = vtrace(zeros, zeros, torch.ones(T, N), zeros, zeros,
                   torch.zeros(N), gamma=1.0)
    np.testing.assert_allclose(
        vs.numpy(), np.arange(T, 0, -1, dtype=np.float32)[:, None]
        .repeat(N, 1), atol=1e-5)


def _batch(rng, obs_shape, num_actions, T=16, N=32):
    if len(obs_shape) == 3:  # MinAtar boards: 0/1 float planes
        obs = (rng.random((T, N) + obs_shape) < 0.3).astype(np.float32)
    else:
        obs = rng.normal(0, 0.5, (T, N) + obs_shape).astype(np.float32)
    return {
        "obs": obs,
        "actions": rng.integers(0, num_actions, (T, N)).astype(np.int32),
        "behaviour_logp": np.log(rng.uniform(0.1, 0.9, (T, N))
                                 ).astype(np.float32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "dones": (rng.random((T, N)) < 0.1).astype(np.float32),
        "last_value": rng.normal(size=N).astype(np.float32)}


SPECS = {"cartpole": (JSpec(obs_dim=4, num_actions=2),
                      RLModuleSpec(obs_dim=4, num_actions=2), (4,)),
         "minatar": (JSpec(obs_shape=(10, 10, 4), num_actions=3, conv=True),
                     RLModuleSpec(obs_shape=(10, 10, 4), num_actions=3,
                                  conv=True), (10, 10, 4))}


def _modules(name, seed=0):
    jspec, tspec, obs_shape = SPECS[name]
    jm = jspec.build()
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.asarray(jspec.example_obs()).astype(jnp.float32))
    tm = tspec.build()
    tm.load_state_dict(actor_critic_from_flax(jax.tree_util.tree_map(
        np.asarray, params)), strict=True)
    return jm, params, tm, obs_shape


LOSSES = {"impala": (jimpala.impala_loss, timpala.impala_loss, {}),
          "appo": (jappo.appo_loss, tappo.appo_loss, {"clip_param": 0.2})}


def _grad_close(got, want, name):
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= GRAD_REL * scale, name


@pytest.mark.parametrize("env", ["cartpole", "minatar"])
@pytest.mark.parametrize("algo", ["impala", "appo"])
def test_loss_and_gradients_match_jax(algo, env):
    jloss, tloss, extra = LOSSES[algo]
    jm, params, tm, obs_shape = _modules(env)
    batch = _batch(np.random.default_rng(2), obs_shape,
                   SPECS[env][0].num_actions)
    (jtotal, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        params, jm, {k: jnp.asarray(v) for k, v in batch.items()},
        **COEFFS, **extra)
    total, aux = tloss(tm, {k: torch.from_numpy(v)
                            for k, v in batch.items()}, **COEFFS, **extra)
    total.backward()
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=LOSS_RTOL)
    for k in ("policy_loss", "vf_loss", "entropy"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]),
                                   rtol=LOSS_RTOL, atol=1e-6)
    want = actor_critic_from_flax(jax.tree_util.tree_map(np.asarray,
                                                         jgrads))
    for name, p in tm.named_parameters():
        _grad_close(p.grad.numpy(), want[name].numpy(), name)


def test_one_impala_update_matches_jax():
    """IMPALA's update as the JAX step applies it: value_and_grad of
    impala_loss over the whole trajectory, clip_by_global_norm(0.5),
    adam(5e-4); the port's loss, autograd and update plan."""
    lr = 5e-4
    jm, params, tm, obs_shape = _modules("minatar", seed=3)
    batch = _batch(np.random.default_rng(4), obs_shape, 3)
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(lr))
    grads = jax.grad(lambda p: jimpala.impala_loss(
        p, jm, {k: jnp.asarray(v) for k, v in batch.items()},
        **COEFFS)[0])(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = actor_critic_from_flax(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, updates)))
    clipped, _ = optax.clip_by_global_norm(0.5).update(grads, None)
    noise = {k: np.abs(v.numpy()) < NOISE_GRAD for k, v in
             actor_critic_from_flax(jax.tree_util.tree_map(
                 np.asarray, clipped)).items()}

    class Config:
        zero_sharding = quantized_collectives = "off"

    tparams = list(tm.parameters())
    update_fn, _ = tmesh.build_update_plan(Config(), lr, 0.5, tparams)
    loss, _ = timpala.impala_loss(tm, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}, **COEFFS)
    with torch.no_grad():
        start = {k: v.clone() for k, v in tm.state_dict().items()}
    update_fn(torch.autograd.grad(loss, tparams))
    for name, p in tm.state_dict().items():
        diff = np.abs(p.numpy() - want[name].numpy())
        assert diff[~noise[name]].max() <= UPDATE_ATOL, name
        assert diff.max() <= 2 * lr, name
        assert noise[name].mean() < 0.02, name
        assert (p - start[name]).abs().max() > 0.5 * lr, name


def _learn(config, goal, iters):
    algo = config.resources(device="cpu").debugging(seed=0).build()
    best = -1.0
    for _ in range(iters):
        result = algo.train()
        if math.isfinite(result["episode_reward_mean"]):
            best = max(best, result["episode_reward_mean"])
        if best >= goal:
            break
    return algo, result, best


def test_impala_learns_cartpole():
    """tests/test_rl_utils.py:77's gate: best reward >= 80 within 150."""
    algo, result, best = _learn(
        IMPALAConfig().environment("CartPole-v1")
        .anakin(num_envs=64, unroll_length=32)
        .training(lr=5e-4, entropy_coeff=0.01), 80, 150)
    assert best >= 80, f"IMPALA made no progress: best={best}"
    assert result["num_env_steps_sampled"] == 64 * 32 * result[
        "training_iteration"]
    assert {"total_loss", "policy_loss", "vf_loss", "entropy"} <= set(result)
    out = algo.evaluate(num_steps=600)
    assert out["episode_reward_mean"] > 20


def test_appo_learns_cartpole():
    """tests/test_more_algos.py:13's gate: best reward >= 150 within 150."""
    _, _, best = _learn(
        APPOConfig().environment("CartPole-v1")
        .anakin(num_envs=32, unroll_length=64)
        .training(lr=5e-4, entropy_coeff=0.01), 150, 150)
    assert best >= 150, f"APPO failed to learn CartPole: best={best}"


def test_configs_carry_the_reference_defaults():
    from ray_tpu.rllib import APPOConfig as JAPPOConfig
    from ray_tpu.rllib import IMPALAConfig as JIMPALAConfig

    for jc, tc in ((JIMPALAConfig(), IMPALAConfig()),
                   (JAPPOConfig(), APPOConfig())):
        for k in ("num_sgd_iter", "entropy_coeff", "lr", "clip_param",
                  "vf_loss_coeff", "vtrace_clip_rho", "vtrace_clip_c",
                  "gamma", "grad_clip", "lstm_cell_size", "attention_dim",
                  "attention_window", "attention_num_heads",
                  "attention_num_layers", "hiddens", "use_lstm",
                  "use_attention"):
            assert getattr(tc, k) == getattr(jc, k), k
