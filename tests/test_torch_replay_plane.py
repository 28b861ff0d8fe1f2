"""The port's replay plane (``ray_tpu_torch/rllib/execution/replay_plane.py``
and ``rllib/utils/replay_buffers.py``) against the JAX package's.

Both are numpy over ``np.random.default_rng(seed)`` draws, so on the same
inserts the port must give the JAX package's trees, draws, IS weights,
staleness masks and n-step columns bit for bit.  The reference's own
checks come along: the vectorized tree ops against the scalar loops,
priority-proportional sampling, n-step against a naive walk, stale
priority updates, the staleness gate; and its distributed tests on one
port cluster for the module, every get with a deadline.
"""
import os
import signal
import time

import numpy as np
import pytest
import torch

from ray_tpu.rllib.execution import replay_plane as jplane
from ray_tpu.rllib.utils import replay_buffers as jbuf
from ray_tpu_torch.rllib.execution import replay_plane as tplane
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.utils import replay_buffers as tbuf

T = 60  # seconds: the bound of every get and wait in this file


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frag(rng, n=64, dim=3):
    return {"obs": rng.standard_normal((n, dim)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int64),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "next_obs": rng.standard_normal((n, dim)).astype(np.float32),
            "dones": (rng.random(n) < 0.1).astype(np.float32)}


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


# ---- segment trees and the prioritized buffer: bit for bit -----------------

def test_segment_tree_batch_ops_match_scalar_and_jax():
    rng = np.random.default_rng(11)
    for _ in range(5):
        trees = {(pkg, kind): getattr(pkg, kind)(128)
                 for pkg in (jbuf, tbuf)
                 for kind in ("SumSegmentTree", "MinSegmentTree")}
        s_ref, m_ref = tbuf.SumSegmentTree(128), tbuf.MinSegmentTree(128)
        # duplicate indices on purpose: set_many must keep the LAST write
        idxs = rng.integers(0, 100, 300)
        vals = rng.random(300) * 5
        for i, v in zip(idxs, vals):
            s_ref[int(i)] = v
            m_ref[int(i)] = v
        for tree in trees.values():
            tree.set_many(idxs, vals)
        for pkg in (jbuf, tbuf):
            assert _same(trees[pkg, "SumSegmentTree"].tree, s_ref.tree)
            assert _same(trees[pkg, "MinSegmentTree"].tree, m_ref.tree)
        draws = rng.random(64) * s_ref.reduce()
        scalar = np.array([s_ref.find_prefixsum_idx(float(d))
                           for d in draws])
        for pkg in (jbuf, tbuf):
            got = trees[pkg, "SumSegmentTree"].find_prefixsum_idx_many(draws)
            assert np.array_equal(scalar, got)


def _transition(pkg_batch, i):
    return pkg_batch({"obs": np.array([[float(i)]], np.float32),
                      "t": np.array([i])})


def test_prioritized_buffer_matches_reference_and_jax():
    """Identical draws at fixed seed: the vectorized sample/update path
    against the scalar reference loop (the reference's check), and the
    port's buffer against the JAX package's, bit for bit."""
    from ray_tpu.rllib.policy.sample_batch import SampleBatch as JBatch

    def build(pkg, batch_cls, seed):
        buf = pkg.PrioritizedReplayBuffer(capacity=64, alpha=0.6, seed=seed)
        r = np.random.default_rng(3)
        for i in range(64):
            buf.add(_transition(batch_cls, i),
                    priority=float(r.random() * 4 + 0.1))
        return buf

    vec, ref = build(tbuf, SampleBatch, 7), build(tbuf, SampleBatch, 7)
    jax_buf = build(jbuf, JBatch, 7)
    for _ in range(4):
        b_v, idx_v, w_v = vec.sample(32, beta=0.5)
        b_r, idx_r, w_r = ref.sample_reference(32, beta=0.5)
        b_j, idx_j, w_j = jax_buf.sample(32, beta=0.5)
        assert idx_v == idx_r == idx_j
        assert np.allclose(w_v, w_r, rtol=1e-6)
        assert _same(w_v, w_j)
        assert np.array_equal(b_v["t"], b_r["t"])
        assert _same(b_v["t"], b_j["t"])
        prios = np.abs(np.sin(np.asarray(idx_v, np.float64))) + 0.05
        vec.update_priorities(idx_v, prios)
        ref.update_priorities_reference(idx_r, prios)
        jax_buf.update_priorities(idx_j, prios)
        # numpy's vectorized ** and python's scalar float ** may differ
        # by 1 ulp; the idx equality above is the exact-draw gate.
        assert np.allclose(vec._sum.tree, ref._sum.tree, rtol=1e-12)
        assert np.allclose(vec._min.tree, ref._min.tree, rtol=1e-12)
        assert _same(vec._sum.tree, jax_buf._sum.tree)
        assert _same(vec._min.tree, jax_buf._min.tree)
        assert vec._max_priority == jax_buf._max_priority


def test_uniform_buffer_matches_jax():
    from ray_tpu.rllib.policy.sample_batch import SampleBatch as JBatch

    bufs = []
    for pkg, batch_cls in ((tbuf, SampleBatch), (jbuf, JBatch)):
        buf = pkg.ReplayBuffer(capacity=16, seed=5)
        for i in range(40):  # wraps the ring twice
            buf.add(_transition(batch_cls, i))
        bufs.append(buf)
    assert len(bufs[0]) == len(bufs[1]) == 16
    for _ in range(3):
        a, b = (buf.sample(8) for buf in bufs)
        assert _same(a["t"], b["t"]) and _same(a["obs"], b["obs"])


def test_schedules_match_jax():
    from ray_tpu.rllib.utils import schedules as js
    from ray_tpu_torch.rllib.utils import schedules as ts

    for make in (lambda m: m.ConstantSchedule(0.3),
                 lambda m: m.LinearSchedule(100, 1.0, 0.05),
                 lambda m: m.ExponentialSchedule(50, 1.0, 0.1),
                 lambda m: m.PiecewiseSchedule([(0, 1.0), (10, 0.5),
                                                (30, 0.1)], 0.01)):
        port, ref = make(ts), make(js)
        for t in (-5, 0, 3, 10, 29, 30, 99, 100, 250):
            assert port(t) == ref(t)


# ---- n-step ----------------------------------------------------------------

def _naive_nstep(rewards, dones, next_obs, num_envs, gamma, n_step):
    """Per-row scalar reference: walk forward up to n steps, stop after
    folding a done row or hitting the fragment end."""
    n = len(rewards)
    T_ = n // num_envs
    R = np.zeros(n)
    nxt = np.array(next_obs, copy=True)
    dfin = np.zeros(n)
    disc = np.zeros(n)
    for row in range(n):
        t, e = divmod(row, num_envs)
        acc, g, m = 0.0, 1.0, 0
        for k in range(n_step):
            if t + k >= T_:
                break
            r2 = (t + k) * num_envs + e
            acc += g * rewards[r2]
            g *= gamma
            m += 1
            last = r2
            if dones[r2]:
                break
        R[row] = acc
        nxt[row] = next_obs[last]
        dfin[row] = dones[last]
        disc[row] = (gamma ** m) * (1.0 - dones[last])
    return R, nxt, dfin, disc


@pytest.mark.parametrize("n_step", [1, 3, 5])
def test_nstep_matches_jax_and_naive_reference(n_step):
    rng = np.random.default_rng(17)
    T_, N = 12, 3
    n = T_ * N
    batch = {
        "obs": rng.standard_normal((n, 2)).astype(np.float32),
        "rewards": rng.standard_normal(n).astype(np.float32),
        # dense done pattern to exercise episode-boundary truncation
        "dones": (rng.random(n) < 0.25).astype(np.float32),
        "next_obs": rng.standard_normal((n, 2)).astype(np.float32),
    }
    out = tplane.compute_nstep(batch, N, gamma=0.9, n_step=n_step)
    want = jplane.compute_nstep(batch, N, gamma=0.9, n_step=n_step)
    assert sorted(out) == sorted(want)
    for k in want:
        assert _same(out[k], want[k]), k
    R, nxt, dfin, disc = _naive_nstep(batch["rewards"], batch["dones"],
                                      batch["next_obs"], N, 0.9, n_step)
    assert np.allclose(out["rewards"], R, atol=1e-5)
    assert np.allclose(out["next_obs"], nxt)
    assert np.array_equal(out["dones"], dfin.astype(np.float32))
    assert np.allclose(out["discounts"], disc, atol=1e-6)
    assert np.array_equal(out["obs"], batch["obs"])  # obs untouched


def test_nstep_fragment_tail_truncates():
    """The last rows of a fragment fold only the steps that exist."""
    T_, N = 4, 1
    batch = {"rewards": np.ones(T_, np.float32),
             "dones": np.zeros(T_, np.float32),
             "next_obs": np.arange(T_, dtype=np.float32).reshape(T_, 1),
             "obs": np.zeros((T_, 1), np.float32)}
    out = tplane.compute_nstep(batch, N, gamma=0.5, n_step=3)
    # row 0: 1 + .5 + .25; row 2 (tail): 1 + .5; row 3: 1
    assert np.allclose(out["rewards"], [1.75, 1.75, 1.5, 1.0])
    assert np.allclose(out["discounts"], [0.125, 0.125, 0.25, 0.5])
    assert out["next_obs"][3, 0] == 3.0 and out["next_obs"][2, 0] == 3.0


# ---- ShardCore and the local plane ------------------------------------------

def test_sampling_frequency_proportional_to_priority():
    core = tplane.ShardCore(256, alpha=1.0, seed=5)
    prios = np.linspace(0.5, 8.0, 256)
    core.insert_fragment({"row": np.arange(256)}, 256, priorities=prios)
    counts = np.zeros(256)
    draws = 60_000
    for _ in range(draws // 500):
        rows = core.sample_rows(500)
        np.add.at(counts, rows["leaf"], 1)
    expected = prios / prios.sum() * draws
    # Pearson chi-square statistic; dof=255.  The 99.9th percentile of
    # chi2(255) is ~344 — a generous-but-real bound that still fails
    # instantly for uniform sampling (statistic would be ~19000).
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 450.0, f"chi-square {chi2:.1f} vs priority-proportional"


def test_uniform_mode_alpha_zero():
    core = tplane.ShardCore(128, alpha=0.0, seed=0)
    core.insert_fragment({"x": np.arange(128)}, 128,
                         priorities=np.linspace(0.1, 9.0, 128))
    rows = core.sample_rows(1000)
    # alpha=0 flattens priorities: every leaf mass is 1.0
    assert np.allclose(rows["p"], 1.0)


def _cores(capacity=128, alpha=0.6, seed=0):
    return (tplane.ShardCore(capacity, alpha=alpha, seed=seed),
            jplane.ShardCore(capacity, alpha=alpha, seed=seed))


def test_stale_priority_updates_dropped_as_in_jax():
    rng = np.random.default_rng(0)
    frags = [_frag(rng) for _ in range(3)]
    out = []
    for core in _cores():
        core.insert_fragment(frags[0], 64)
        core.insert_fragment(frags[1], 64)
        rows = core.sample_rows(32)
        # Evict slot 0 by wrapping the 2-slot ring; its seq bumps.
        core.insert_fragment(frags[2], 64)
        applied = core.update_priorities(rows["leaf"], rows["seq"],
                                         np.full(32, 5.0))
        in_slot0 = int((rows["slot"] == 0).sum())
        assert applied == 32 - in_slot0
        assert core.stale_updates == in_slot0 > 0
        out.append((rows, core._sum.tree.copy(), core.stats()))
    (rows, tree, stats), (jrows, jtree, jstats) = out
    for k in ("slot", "offset", "leaf", "seq", "p", "version"):
        assert _same(rows[k], jrows[k]), k
    assert _same(tree, jtree) and stats == jstats


def _planes(**kw):
    kw = {"capacity": 2048, "num_shards": 0, "alpha": 0.6, "seed": 0, **kw}
    return tplane.ReplayPlane(**kw), jplane.ReplayPlane(**kw)


@pytest.mark.parametrize("alpha", [0.0, 0.6], ids=["uniform", "prioritized"])
def test_local_plane_draws_match_jax(alpha):
    """Ids, IS weights, versions and every column of the local plane's
    batches bit for bit the JAX plane's, through inserts that wrap the
    ring, priority updates and the staleness gate."""
    planes = _planes(capacity=1024, alpha=alpha, max_weight_staleness=2)
    rng = np.random.default_rng(1)
    for v in range(6):  # 6 fragments of 256 in a 4-slot ring
        frag = _frag(rng, 256)
        prios = np.abs(rng.standard_normal(256)) + 0.01
        for plane in planes:
            plane.insert(frag, priorities=prios, version=v)
    for plane in planes:
        plane.note_weights_version(5)  # versions <= 2 lag by > 2 -> stale
    for i in range(3):
        batches = [plane.sample(128, rng=np.random.default_rng(10 + i))
                   for plane in planes]
        got, want = batches
        for k in ("ids", "weights", "versions"):
            assert _same(getattr(got, k), getattr(want, k)), k
        assert sorted(got.data) == sorted(want.data)
        for k in want.data:
            assert _same(got[k], want[k]), k
        stale = got.versions < 3
        if stale.any():
            assert (got.weights[stale] == 0.0).all()
        new = np.abs(np.sin(got.ids[:, 1].astype(np.float64))) + 0.1
        for plane in planes:
            plane.update_priorities(got.ids, new)
    assert planes[0].stats() == planes[1].stats()
    for plane in planes:
        plane.close()


def test_sample_stacked_matches_jax():
    planes = _planes()
    rng = np.random.default_rng(4)
    for _ in range(4):
        frag = _frag(rng, 256)
        for plane in planes:
            plane.insert(frag, priorities=np.abs(frag["rewards"]) + 0.01)
    got = planes[0].sample_stacked(np.random.default_rng(7), 5, 32)
    want = planes[1].sample_stacked(np.random.default_rng(7), 5, 32)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert _same(t.numpy(), np.asarray(want[k])) or (
            k == "actions" and np.array_equal(t.numpy(), want[k])), k
    # return_ids: the same draws, plus the weights and the ids.
    cols, ids = planes[0].sample_stacked(np.random.default_rng(7), 5, 32,
                                         return_ids=True)
    for k in got:
        assert torch.equal(cols[k], got[k])
    ref = [planes[1].sample(32, rng=r) for r in [np.random.default_rng(7)]
           for _ in range(5)]
    assert _same(ids, np.stack([b.ids for b in ref]))
    assert _same(cols["weights"].numpy(), np.stack([b.weights for b in ref]))
    for plane in planes:
        plane.close()


def test_device_staging_round_trips_every_dtype():
    """One buffer, one copy: the columns come back as they went in,
    whatever their dtypes and sizes (8-byte alignment between them), and
    a reused buffer does not alias the previous call's tensors."""
    staging = tplane._DeviceStaging()
    rng = np.random.default_rng(0)
    arrays = {"f": rng.standard_normal((3, 5, 7)).astype(np.float32),
              "i": rng.integers(-9, 9, (3, 5)).astype(np.int64),
              "b": rng.random((3, 5)) < 0.5,
              "h": rng.standard_normal(3).astype(np.float16)}
    first = staging.to_device(arrays)
    for k, a in arrays.items():
        assert _same(first[k].numpy(), a), k
    second = staging.to_device({k: np.zeros_like(a)
                                for k, a in arrays.items()})
    for k, a in arrays.items():
        assert _same(first[k].numpy(), a) and not second[k].any(), k


def test_local_plane_deterministic_draws():
    def draws(seed):
        p = tplane.ReplayPlane(2048, num_shards=0, alpha=0.6, seed=0)
        r = np.random.default_rng(1)
        for _ in range(4):
            p.insert(_frag(r, 256),
                     priorities=np.abs(r.standard_normal(256)) + 0.01)
        out = p.sample(64, rng=np.random.default_rng(seed))
        p.close()
        return out

    a, b = draws(9), draws(9)
    assert np.array_equal(a.ids, b.ids)
    assert np.array_equal(a.weights, b.weights)
    assert np.array_equal(a["obs"], b["obs"])


def test_max_weight_staleness_gate_zeroes_weights():
    plane = tplane.ReplayPlane(2048, num_shards=0, alpha=0.0, seed=0,
                               max_weight_staleness=2)
    rng = np.random.default_rng(2)
    for v in range(4):
        plane.insert(_frag(rng, 256), version=v)
    plane.note_weights_version(3)  # versions 0 lag by 3 > 2 -> stale
    batch = plane.sample(512)
    stale = batch.versions < 1
    assert stale.any() and (~stale).any()
    assert (batch.weights[stale] == 0.0).all()
    assert (batch.weights[~stale] == 1.0).all()
    plane.close()


def test_from_config_reads_the_replay_knobs():
    from ray_tpu_torch.rllib import DQNConfig

    cfg = DQNConfig()
    cfg.buffer_size, cfg.replay_prioritized, cfg.n_step = 4096, True, 3
    cfg.replay_max_weight_staleness = 5
    plane = tplane.ReplayPlane.from_config(cfg, seed=3)
    assert (plane.capacity, plane.alpha, plane.n_step, plane.gamma,
            plane.max_weight_staleness) == (4096, 0.6, 3, 0.99, 5)
    assert not plane.distributed
    plane.close()


# ---- the distributed plane on the port's runtime ----------------------------

@pytest.fixture(scope="module")
def cluster():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, object_store_memory=128 * 1024**2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _fill(plane, rng, frags=9, n=128):
    for v in range(frags):
        plane.insert(_frag(rng, n), version=v)


def _wait_for(cond, what):
    deadline = time.monotonic() + T
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.1)
    pytest.fail(f"waited {T} s for {what}")


def test_distributed_plane_sample_one_gather(cluster):
    plane = tplane.ReplayPlane(4096, num_shards=2, alpha=0.6, seed=0)
    try:
        rng = np.random.default_rng(0)
        _fill(plane, rng)
        assert plane.size == 9 * 128
        g0 = plane.gather_calls
        batch = plane.sample(96)
        assert plane.gather_calls == g0 + 1  # ONE get_many per batch
        assert batch["obs"].shape == (96, 3)
        assert batch["obs"].dtype == np.float32
        # priority updates round-trip through the coalesced async stage
        plane.update_priorities(batch.ids, np.full(96, 3.0))

        def landed():
            plane.sample(8)  # refreshes the shard mass snapshot
            return sum(plane.stats()["per_shard_mass"]) > 9 * 128 + 0.5

        _wait_for(landed, "the async priority updates")
        stacked = plane.sample_stacked(np.random.default_rng(1), 3, 16)
        assert stacked["obs"].shape == (3, 16, 3)
    finally:
        plane.close()


def test_sharded_plane_holds_every_fragment_a_shard_indexes(cluster):
    """The driver keeps each fragment's refs until its shard has evicted
    it: whatever a shard can hand a sample (its ring, after wraps) is
    still held, so no gather meets a freed fragment; the oldest leave."""
    plane = tplane.ReplayPlane(1024, num_shards=2, alpha=0.0, seed=0)
    try:
        rng = np.random.default_rng(5)
        _fill(plane, rng, frags=12)  # 6 a shard into rings of 4 slots
        assert plane.size == 2 * 4 * 128
        for i, shard in enumerate(plane._shard_set.workers):
            held = {r.binary() for refs in plane._held[i]
                    for r in refs.values()}
            assert len(plane._held[i]) == 4 + 1
            reply = cluster.get(shard.sample.remote(256), timeout=T)
            served = {r.binary() for refs in reply["payloads"].values()
                      for r in refs.values()}
            assert len(reply["payloads"]) == 4 and served <= held
    finally:
        plane.close()


def test_shard_death_chaos_no_lost_learner_step(cluster):
    """SIGKILL one shard mid-run: sampling must degrade gracefully (full
    batch from the survivors), inserts keep landing, and the strike
    machinery replaces the dead shard."""
    plane = tplane.ReplayPlane(6144, num_shards=3, alpha=0.0, seed=0)
    try:
        rng = np.random.default_rng(1)
        _fill(plane, rng, frags=12)
        assert plane.sample(64)["obs"].shape == (64, 3)
        victim = plane._shard_set.workers[1]
        os.kill(cluster.get(victim.pid.remote(), timeout=T), signal.SIGKILL)
        time.sleep(0.3)
        # Every learner step still gets a FULL batch.
        for _ in range(3):
            batch = plane.sample(64)
            assert len(batch) == 64
            assert batch["obs"].shape == (64, 3)
        # Inserts keep landing after the failure too.
        _fill(plane, rng, frags=3)
        assert plane.sample(64)["obs"].shape == (64, 3)
    finally:
        plane.close()


def test_prefetch_stage_yields_batches(cluster):
    plane = tplane.ReplayPlane(4096, num_shards=2, alpha=0.0, seed=0)
    stage = None
    try:
        _fill(plane, np.random.default_rng(2))
        stage = plane.prefetch(32, depth=2)
        got = [next(stage) for _ in range(4)]
        assert all(b["obs"].shape == (32, 3) for b in got)
    finally:
        if stage is not None:
            stage.close()
        plane.close()


def test_replay_metrics_prometheus_export(cluster):
    from ray_tpu_torch.util.metrics import prometheus_text

    plane = tplane.ReplayPlane(2048, num_shards=0, alpha=0.0, seed=0)
    try:
        rng = np.random.default_rng(4)
        for v in range(3):
            plane.insert(_frag(rng, 256), version=v)
        plane.sample(64)
        plane.flush_metrics()
        text = prometheus_text()
    finally:
        plane.close()
    for name in ("replay_inserts_total", "replay_insert_rows_total",
                 "replay_samples_total", "replay_sample_rows_total",
                 'replay_shard_fill{shard="0"}',
                 "replay_shard_priority_mass"):
        assert name in text, name
