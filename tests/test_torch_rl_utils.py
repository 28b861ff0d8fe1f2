"""The port's observation filters and connectors against the JAX
package's (both numpy; the port holds copies).  The scenarios of
``tests/test_rl_utils.py``'s filter and connector tests run through both
packages and must give the same arrays bit for bit."""
import numpy as np
import pytest

from ray_tpu.rllib import connectors as jconn
from ray_tpu.rllib.utils import filters as jfilt
from ray_tpu_torch.rllib import connectors as tconn
from ray_tpu_torch.rllib.utils import filters as tfilt


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("mod", [jfilt, tfilt], ids=["jax", "torch"])
def test_mean_std_filter_and_merge(mod):
    """tests/test_rl_utils.py::test_mean_std_filter_and_merge."""
    f1, f2 = mod.MeanStdFilter((3,)), mod.MeanStdFilter((3,))
    rng = np.random.default_rng(0)
    a, b = rng.normal(5, 2, (100, 3)), rng.normal(5, 2, (80, 3))
    f1(a)
    f2(b)
    central = mod.MeanStdFilter((3,))
    central.apply_delta(f1.collect_delta())
    central.apply_delta(f2.collect_delta())
    all_data = np.concatenate([a, b])
    np.testing.assert_allclose(central.stat.mean, all_data.mean(0),
                               atol=1e-8)
    np.testing.assert_allclose(central.stat.std, all_data.std(0), rtol=1e-2)


def test_filters_bit_for_bit():
    rng = np.random.default_rng(1)
    xs = [rng.normal(3, 2, (16, 4)) for _ in range(3)] + [rng.normal(size=4)]
    outs = []
    for mod in (jfilt, tfilt):
        f = mod.MeanStdFilter((4,), clip=2.0)
        g = mod.MeanStdFilter((4,), demean=False, destd=True, clip=None)
        seq = [f(x) for x in xs] + [g(x) for x in xs]
        seq.append(f(xs[0], update=False))
        delta = f.collect_delta()
        assert delta.n == 16 * 3 + 1 and f.collect_delta().n == 0
        g.apply_delta(delta)
        h = mod.MeanStdFilter((4,))
        h.sync(g)
        seq += [g.stat.mean, g.stat.m2, h.stat.std, h.stat.var,
                mod.RunningStat((2,)).var, h.stat.copy().mean]
        outs.append(seq)
    for a, b in zip(*outs):
        _same(a, b)


@pytest.mark.parametrize("mod", [jconn, tconn], ids=["jax", "torch"])
def test_connector_pipeline_roundtrip(mod):
    """tests/test_rl_utils.py::test_connector_pipeline_roundtrip."""
    pipe = mod.ConnectorPipeline([mod.NormalizeObs((4,))])
    rng = np.random.default_rng(0)
    for _ in range(10):
        pipe(rng.normal(3, 1, (32, 4)))
    name, state = pipe.to_state()
    restored = mod.Connector.from_state(name, state)
    x = rng.normal(3, 1, (8, 4))
    np.testing.assert_allclose(
        pipe.connectors[0].filter(x, update=False),
        restored.connectors[0].filter(x, update=False), atol=1e-6)


def test_connectors_bit_for_bit():
    rng = np.random.default_rng(2)
    obs = rng.normal(2, 3, (6, 2, 3, 2))
    rewards = rng.normal(0, 2, 6)
    actions = rng.normal(0, 2, (6, 2))
    outs = []
    for mod in (jconn, tconn):
        pipe = mod.ConnectorPipeline([mod.FlattenObs(),
                                      mod.NormalizeObs((12,))])
        seq = [pipe(obs), pipe(obs[:3]), mod.ClipReward(1.5)(rewards),
               mod.ClipAction(-0.5, 0.7)(actions)]
        state = mod.ConnectorPipeline([
            pipe, mod.ClipReward(1.5), mod.ClipAction(-0.5, 0.7)]).to_state()
        restored = mod.Connector.from_state(*state)
        seq += [restored.connectors[0](obs),
                restored.connectors[1](rewards),
                restored.connectors[2](actions)]
        outs.append((seq, state))
    (jseq, jstate), (tseq, tstate) = outs
    assert jstate == tstate
    for a, b in zip(jseq, tseq):
        _same(a, b)
    with pytest.raises(NotImplementedError):
        tconn.Connector()(1)
