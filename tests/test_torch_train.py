"""The port's GPT-2 training step against the JAX package's.

``GPT2Config.tiny`` in fp32: the flax model is initialised from a seed,
its params are carried across with ``gpt2_params_from_jax``, and the same
token ids (numpy, from a seed) go through ``ray_tpu.models.gpt2``'s
``gpt2_loss_fn`` with ``jax.value_and_grad`` and ``optax.adamw(3e-4)``,
as ``bench.py::gpt2_train_loop`` steps it, and through the port's
``gpt2_loss_fn``, ``adamw`` and ``make_train_step`` on the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.models import GPT2 as JGPT2
from ray_tpu.models import GPT2Config as JConfig
from ray_tpu.models.gpt2 import gpt2_loss_fn as jax_loss_fn
from ray_tpu_torch.models import GPT2, GPT2Config, gpt2_loss_fn
from ray_tpu_torch.models.convert import gpt2_params_from_jax
from ray_tpu_torch.train import adamw, make_train_step

LR = 3e-4
STEPS = 5
# fp32 losses and gradients: the same sums in other orders; the loss is
# ~6 and gradients ~1e-3-5e-2, measured apart by <= 1.5e-6 and
# <= 6e-8.
LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7
# Parameters after STEPS AdamW steps.  Adam scales each gradient by its
# own running RMS, so an element whose gradient is rounding noise (the
# key bias: adding a constant to every key leaves each softmax row
# unchanged, so its true gradient is 0) moves by ~lr per step in a
# direction set by that noise, and the two packages' noise differs.  With
# bias correction, after t <= 5 steps |m_hat| / sqrt(v_hat) <=
# sqrt(sum_i a_i^2 / b_i) <= 1.011 (Cauchy-Schwarz, a_i and b_i the
# moments' weights), so each step moves an element by at most 1.011 lr
# (plus lr * 1e-4 * |p| of decay) in either package, and two runs drift
# apart by at most 2 * 1.011 * lr per step: that bound holds for every
# element.  Elements with a well-determined gradient take the same
# update to fp32 rounding, so all but a small fraction (the key bias is
# ~0.1% of the tiny model's elements; measured 0.08% beyond 1e-6) agree
# to 1e-6.
PARAM_ATOL = 2 * 1.02 * LR * STEPS
PARAM_CLOSE_ATOL, PARAM_CLOSE_FRACTION = 1e-6, 0.99


def _models(seed=0):
    jmodel = JGPT2(JConfig.tiny(dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel = GPT2(GPT2Config.tiny(dtype=torch.float32))
    tmodel.load_state_dict(gpt2_params_from_jax(_numpy(params)),
                           strict=True)
    return jmodel, params, tmodel


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ids(seed=0, b=4, length=64):
    return np.random.default_rng(seed).integers(0, 512, (b, length))


def test_loss_and_every_gradient_match_jax():
    """gpt2_loss_fn == JAX's, and every parameter's gradient == jax.grad
    of JAX's, converted by gpt2_params_from_jax (Dense kernels
    transposed; wte takes both the embedding's and the tied head's
    share)."""
    jmodel, params, tmodel = _models()
    ids = _ids()
    loss_j, grads_j = jax.value_and_grad(jax_loss_fn)(
        params, jmodel.apply, {"input_ids": jnp.asarray(ids)})
    loss_t = gpt2_loss_fn(tmodel, {"input_ids": torch.from_numpy(ids)})
    assert loss_t.dim() == 0
    np.testing.assert_allclose(loss_t.item(), float(loss_j),
                               rtol=LOSS_RTOL)
    loss_t.backward()
    want = gpt2_params_from_jax(_numpy(grads_j))
    got = dict(tmodel.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_adamw_has_optax_defaults():
    """adamw(3e-4) is optax.adamw(3e-4)'s optimizer: betas (0.9, 0.999),
    eps 1e-8, weight decay 1e-4 (not torch's 1e-2), on every parameter."""
    _, _, tmodel = _models()
    opt = adamw(tmodel.parameters())
    assert len(opt.param_groups) == 1
    group = opt.param_groups[0]
    assert group["lr"] == LR
    assert group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8
    assert group["weight_decay"] == 1e-4
    assert not group["amsgrad"]
    assert {id(p) for p in group["params"]} == \
        {id(p) for p in tmodel.parameters()}


def test_five_adamw_steps_match_optax():
    """A 5-step loss trajectory and the final parameters of
    make_train_step(adamw(3e-4)) == optax.adamw(3e-4) driven by
    jax.value_and_grad -> tx.update -> apply_updates on the same ids
    every step (bench.py's synthetic branch).  Bounds: PARAM_ATOL,
    PARAM_CLOSE_ATOL and PARAM_CLOSE_FRACTION above."""
    jmodel, params, tmodel = _models()
    ids = _ids(1)
    tx = optax.adamw(LR)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(params, opt_state, ids):
        loss, grads = jax.value_and_grad(jax_loss_fn)(
            params, jmodel.apply, {"input_ids": ids})
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    step = make_train_step(tmodel, adamw(tmodel.parameters(), LR),
                           gpt2_loss_fn)
    batch = {"input_ids": torch.from_numpy(ids)}
    losses_j, losses_t = [], []
    for _ in range(STEPS):
        params, opt_state, loss = jax_step(params, opt_state,
                                           jnp.asarray(ids))
        losses_j.append(float(loss))
        loss_t = step(batch)
        assert loss_t.dim() == 0 and not loss_t.requires_grad
        losses_t.append(loss_t.item())
    np.testing.assert_allclose(losses_t, losses_j, rtol=LOSS_RTOL)
    assert losses_t[-1] < losses_t[0]
    want = gpt2_params_from_jax(_numpy(params))
    diffs = []
    for name, p in tmodel.named_parameters():
        diff = (p.detach() - want[name]).abs()
        assert diff.max().item() <= PARAM_ATOL, name
        diffs.append(diff.flatten())
    diffs = torch.cat(diffs)
    close = (diffs <= PARAM_CLOSE_ATOL).float().mean().item()
    assert close >= PARAM_CLOSE_FRACTION, close


def test_train_step_runs_where_the_model_is():
    """Nothing in the step picks a device: on a CPU model the loss comes
    back on the CPU, and the parameters moved."""
    _, _, tmodel = _models()
    before = tmodel.wte.detach().clone()
    step = make_train_step(tmodel, adamw(tmodel.parameters()),
                           gpt2_loss_fn)
    loss = step({"input_ids": torch.from_numpy(_ids(2, 2, 16))})
    assert loss.device.type == "cpu" and torch.isfinite(loss)
    assert not torch.equal(tmodel.wte.detach(), before)


@pytest.mark.parametrize("length", [2, 17])
def test_loss_is_mean_next_token_cross_entropy(length):
    """The loss is the mean of -log_softmax(logits)[t, ids[t + 1]] over
    the B*(L-1) positions, computed from the fp32 logits."""
    _, _, tmodel = _models()
    ids = torch.from_numpy(_ids(3, 3, length))
    with torch.no_grad():
        logp = torch.log_softmax(tmodel(ids).double(), -1)[:, :-1]
        want = -logp.gather(-1, ids[:, 1:, None]).mean()
        got = gpt2_loss_fn(tmodel, {"input_ids": ids})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)
