"""The replay family's Anakin updates on the card (``dqn.AnakinUpdates``):
their CUDA graphs against the same updates run eagerly, a TD3 checkpoint
restored into a learner whose updates are captured, and the optimizer the
card runs (Adam ``capturable``) against optax's clip + adam.

A CUDA graph exists only on a card, so these tests carry the ``cuda``
marker and skip without one.  The file imports no JAX at module level, so
it also runs on a machine with a card and no JAX:
``python -m pytest tests/test_torch_replay_graphs.py -m cuda -q``.  There
the optimizer is held against ``optax_clip_adam``, a numpy transcription
of optax's operations; ``test_optax_transcription_matches_optax`` holds
the transcription against optax itself wherever optax is installed."""
import numpy as np
import pytest
import torch

# Graph against eager, every parameter and optimizer-state tensor: the
# same kernels from the same state and draws (chip_smoke's
# GRAPH_EAGER_RTOL, in case cuBLAS picks another algorithm in capture).
GRAPH_EAGER_RTOL = 1e-5
# Adam against optax on the same gradients: tests/test_torch_ppo.py's
# bound for optax's rounding.
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-8
# The transcription against optax: the same fp32 operations in the same
# order; what may differ is the order of the global norm's sum and the
# last bit of a power (measured: 2 elements of 902 one ulp apart, 1.9e-9).
TRANSCRIPTION_RTOL, TRANSCRIPTION_ATOL = 1e-6, 1e-9


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _algo(name, device="cuda"):
    from ray_tpu_torch import rllib

    env = "CartPole-v1" if name == "DQN" else "PendulumContinuous-v1"
    cfg = (getattr(rllib, f"{name}Config")().environment(env)
           .anakin(num_envs=16, unroll_length=8).debugging(seed=0)
           .resources(device=device))
    cfg.learning_starts, cfg.num_updates_per_iter = 128, 6
    return cfg.build()


def _state(learner):
    tensors = []
    for value in vars(learner).values():
        if isinstance(value, torch.nn.Module):
            tensors += [p.detach().clone() for p in value.parameters()]
        elif isinstance(value, torch.nn.Parameter):
            tensors.append(value.detach().clone())
        elif isinstance(value, torch.optim.Optimizer):
            tensors += [t.clone() for st in value.state.values()
                        for t in st.values() if isinstance(t, torch.Tensor)]
    return tensors


def _assert_states_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        scale = max(b.abs().max().item(), 1e-12)
        assert (a - b).abs().max().item() <= GRAPH_EAGER_RTOL * scale


def optax_clip_adam(params, grads_seq, lr, max_norm, b1=0.9, b2=0.999,
                    eps=1e-8):
    """``optax.chain(clip_by_global_norm(max_norm), adam(lr))`` applied to
    ``params`` (numpy arrays) over the gradients of each step in
    ``grads_seq``: optax 0.2's operations (``clipping.clip_by_global_norm``,
    ``transform.scale_by_adam``, ``scale_by_learning_rate``,
    ``apply_updates``) in their order, in fp32 as optax computes them.
    ``max_norm`` None clips nothing."""
    f32 = np.float32
    params = [np.asarray(p, f32) for p in params]
    mu = [np.zeros_like(p) for p in params]
    nu = [np.zeros_like(p) for p in params]
    for count, grads in enumerate(grads_seq, start=1):
        grads = [np.asarray(g, f32) for g in grads]
        if max_norm is not None:
            norm = np.sqrt(sum(np.sum(g * g) for g in grads)).astype(f32)
            if not norm < f32(max_norm):
                grads = [g / norm * f32(max_norm) for g in grads]
        mu = [f32(1 - b1) * g + f32(b1) * m for g, m in zip(grads, mu)]
        nu = [f32(1 - b2) * (g * g) + f32(b2) * v for g, v in zip(grads, nu)]
        bc1 = f32(1) - f32(b1) ** f32(count)
        bc2 = f32(1) - f32(b2) ** f32(count)
        params = [p + f32(-lr) * ((m / bc1) / (np.sqrt(v / bc2) + f32(eps)))
                  for p, m, v in zip(params, mu, nu)]
    return params


def test_optax_transcription_matches_optax():
    """The transcription against optax on numpy-seeded parameters and 4
    steps of gradients, the second large enough to be clipped."""
    jnp = pytest.importorskip("jax.numpy")
    optax = pytest.importorskip("optax")
    rng = np.random.default_rng(0)
    shapes = [(4, 64), (64,), (64, 2), (2,), ()]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads_seq = [[(rng.standard_normal(s) * scale).astype(np.float32)
                  for s in shapes] for scale in (0.01, 10.0, 0.03, 1e-4)]
    for lr, max_norm in ((5e-4, 0.5), (3e-4, None)):
        tx = optax.adam(lr) if max_norm is None else optax.chain(
            optax.clip_by_global_norm(max_norm), optax.adam(lr))
        want = [jnp.asarray(p) for p in params]
        opt_state = tx.init(want)
        for grads in grads_seq:
            upd, opt_state = tx.update([jnp.asarray(g) for g in grads],
                                       opt_state, want)
            want = optax.apply_updates(want, upd)
        got = optax_clip_adam(params, grads_seq, lr, max_norm)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w),
                                       rtol=TRANSCRIPTION_RTOL,
                                       atol=TRANSCRIPTION_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["DQN", "SAC", "TD3", "DDPG"])
def test_graphed_updates_match_eager(name):
    """Two Anakin runs from one seed, one through the graphs (the card's
    default) and one with them switched off: the same losses and the
    same learner state after 3 iterations (18 updates: 3 eager warm-ups
    a variant, then captures and replays)."""
    _needs_card()
    runs = []
    for graphs in (True, False):
        algo = _algo(name)
        algo._anakin_state.updates.use_graphs = graphs
        losses = [algo.train()["critic_loss" if name != "DQN"
                               else "total_loss"] for _ in range(3)]
        runs.append((losses, _state(algo.learner),
                     algo._anakin_state.updates))
    (lg, sg, updates), (le, se, _) = runs
    assert updates.replays > 0 and updates.graphs
    for a, b in zip(lg, le):
        assert a == pytest.approx(b, rel=GRAPH_EAGER_RTOL, nan_ok=True)
    _assert_states_close(sg, se)


@pytest.mark.cuda
@pytest.mark.parametrize("written_on", ["cuda", "cpu"])
def test_td3_restore_after_capture_matches_a_fresh_restore(written_on):
    """A TD3 run whose updates are captured trains on past a checkpoint
    and is restored from it; a fresh run is restored from the same one.
    Over one ring and one draw generator, their next 8 updates (the first
    run's replayed from its graphs, the fresh run's 3 eager warm-ups a
    variant, then captured) give the same losses and learner state.  The
    checkpoint comes from the captured run itself, or from a CPU run (its
    optimizer groups say ``capturable`` False, its step counts lie on
    the CPU)."""
    from ray_tpu_torch.rllib.algorithms.dqn import REPLAY_COLS

    _needs_card()
    captured = _algo("TD3")
    for _ in range(3):
        captured.train()
    assert captured._anakin_state.updates.graphs
    source = captured if written_on == "cuda" else _algo("TD3", "cpu")
    if written_on == "cpu":
        for _ in range(3):
            source.train()
    ckpt = source.save_checkpoint()
    captured.train()  # its moments move on past the checkpoint's
    fresh = _algo("TD3")
    runs = []
    for algo in (captured, fresh):
        algo.load_checkpoint(ckpt)
        st = algo._anakin_state
        for k in REPLAY_COLS:
            getattr(st.replay, k).copy_(
                getattr(captured._anakin_state.replay, k))
        gen = torch.Generator(device="cuda").manual_seed(7)
        size = captured._anakin_state.replay.size
        losses = [st.updates.update(size, gen)["critic_loss"].item()
                  for _ in range(8)]
        runs.append((losses, _state(algo.learner), st.updates))
    (lc, sc, updates_c), (lf, sf, updates_f) = runs
    assert updates_c.replays >= 8 and len(updates_f.graphs) == 2
    assert lc == pytest.approx(lf, rel=GRAPH_EAGER_RTOL)
    _assert_states_close(sc, sf)
    for opt in (fresh.learner.pi_opt, fresh.learner.q_opt):
        assert all(g["capturable"] for g in opt.param_groups)


def _offpolicy_batch(rng, name, B=64):
    """A numpy-seeded batch on the card: CartPole's shapes for DQN, the
    pendulum's for SAC."""
    if name == "DQN":
        obs_dim, actions = 4, rng.integers(0, 2, B)
    else:
        obs_dim = 3
        actions = rng.uniform(-2, 2, (B, 1)).astype(np.float32)
    batch = {"obs": rng.standard_normal((B, obs_dim)).astype(np.float32),
             "actions": actions,
             "rewards": rng.standard_normal(B).astype(np.float32),
             "next_obs": rng.standard_normal((B, obs_dim)).astype(
                 np.float32),
             "dones": (rng.random(B) < 0.2).astype(np.float32)}
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["DQN", "SAC"])
def test_capturable_adam_matches_optax(name):
    """The optimizer the card's updates run (Adam ``capturable``: its step
    count and bias correction on the device) against optax's clip + adam
    (``optax_clip_adam``) on the gradients the learner took: 3 updates on
    numpy-seeded batches from the learner's seeded initial weights, every
    plan's parameters (DQN's Q network; SAC's critic, actor and alpha)
    within ``ADAM_RTOL``/``ADAM_ATOL`` after each."""
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib.algorithms import dqn, sac

    _needs_card()
    cfg = getattr(rllib, f"{name}Config")().resources(device="cuda")
    init = torch.Generator().manual_seed(0)
    if name == "DQN":
        learner = dqn.DQNLearner(cfg, 4, 2, "cuda", init)
        plans = {"_update_fn": learner._params}
    else:
        learner = sac.SACLearner(cfg, 3, 1, [-2.0], [2.0], "cuda", init)
        plans = {"_q_update": learner._q_params,
                 "_pi_update": learner._pi_params,
                 "_a_update": [learner.log_alpha]}
    start, grads = {}, {}
    for attr, params in plans.items():
        opt_groups = [g for o in vars(learner).values()
                      if isinstance(o, torch.optim.Optimizer)
                      for g in o.param_groups]
        assert all(g["capturable"] for g in opt_groups)
        start[attr] = [p.detach().cpu().numpy() for p in params]
        grads[attr] = []

        def recorded(gs, fn=getattr(learner, attr), log=grads[attr]):
            log.append([g.detach().cpu().numpy() for g in gs])
            return fn(gs)

        setattr(learner, attr, recorded)
    rng = np.random.default_rng(1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for u in range(3):
        learner.update(_offpolicy_batch(rng, name), gen)
        for attr, params in plans.items():
            want = optax_clip_adam(start[attr], grads[attr], cfg.lr,
                                   cfg.grad_clip)
            for p, w in zip(params, want):
                np.testing.assert_allclose(
                    p.detach().cpu().numpy(), w, rtol=ADAM_RTOL,
                    atol=ADAM_ATOL, err_msg=f"{attr} after update {u}")
