"""`rllib train` CLI (counterpart of ``ray_tpu/rllib/train.py``;
reference: rllib/train.py and the tuned_examples yaml format): run any
registered algorithm from flags or a yaml/json experiment file, with stop
criteria and checkpointing.

Usage::

    python -m ray_tpu_torch.rllib.train --algo PPO --env CartPole-v1 \\
        --stop-reward 150 --stop-iters 120 --checkpoint-dir /tmp/ckpt
    python -m ray_tpu_torch.rllib.train -f cartpole-ppo.yaml

The algorithm runs on CUDA unless its config says otherwise
(``--config '{"device": "cpu"}'``, or ``device: cpu`` in a file's
``config``).  A ``.json`` experiment file needs nothing beyond the
standard library; PyYAML is imported only for a yaml file.

Yaml format (reference: rllib/tuned_examples/*.yaml)::

    cartpole-ppo:
      run: PPO
      env: CartPole-v1
      stop: {episode_reward_mean: 150, training_iteration: 120}
      config:
        lr: 0.0003
        num_envs: 64
        model: {fcnet_hiddens: [64, 64]}
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Optional


def apply_config(cfg, config: Dict[str, Any]):
    """Map a tuned-example config dict onto an AlgorithmConfig: `model`
    goes through .training(model=...) (validated keys), everything else
    must be an existing attribute — typos fail loudly, as ``training()``'s
    do."""
    for k, v in config.items():
        if k == "model":
            cfg.training(model=v)
        elif hasattr(cfg, k):
            setattr(cfg, k, v)
        else:
            raise ValueError(f"unknown config key {k!r} for "
                             f"{type(cfg).__name__}")
    return cfg


def run_experiment(run: str, env: str, config: Optional[Dict[str, Any]] = None,
                   stop: Optional[Dict[str, Any]] = None,
                   checkpoint_dir: Optional[str] = None,
                   verbose: bool = True) -> Dict[str, Any]:
    """Train until a stop criterion fires; returns the final metrics
    (plus `checkpoint_path` if a checkpoint dir was given)."""
    from ray_tpu_torch.rllib import get_algorithm_config

    cfg = get_algorithm_config(run).environment(env)
    apply_config(cfg, config or {})
    algo = cfg.build()
    stop = stop or {}
    max_iters = int(stop.get("training_iteration", 100))
    reward_stop = stop.get("episode_reward_mean")
    ts_stop = stop.get("num_env_steps_sampled")
    metrics: Dict[str, Any] = {}
    best = float("-inf")
    for _ in range(max_iters):
        metrics = algo.train()
        r = metrics.get("episode_reward_mean", float("nan"))
        if r == r:
            best = max(best, r)
        if verbose:
            print(f"iter {metrics['training_iteration']}: "
                  f"reward={r if r == r else float('nan'):.2f} "
                  f"steps={metrics.get('num_env_steps_sampled', 0)}",
                  file=sys.stderr)
        if reward_stop is not None and r == r and r >= reward_stop:
            break
        if ts_stop is not None \
                and metrics.get("num_env_steps_sampled", 0) >= ts_stop:
            break
    metrics["best_episode_reward_mean"] = best
    if checkpoint_dir:
        path = algo.save_checkpoint().to_directory(checkpoint_dir)
        metrics["checkpoint_path"] = path
    algo.stop()
    return metrics


def _json_safe(obj):
    """NaN/±inf → None: json.dumps would otherwise emit literals that
    strict JSON consumers (jq, most non-Python parsers) reject."""
    import math

    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def _load_experiments(path: str) -> Dict[str, dict]:
    """A ``.json`` file through ``json``; any other through PyYAML,
    imported only then (the JAX package imports it first, so its JSON
    files fail where PyYAML is missing)."""
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"{path} is a yaml experiment file, which needs PyYAML (not "
            f"installed); write it as a .json file instead") from e
    with open(path) as f:
        return yaml.safe_load(f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rllib train", description=__doc__)
    p.add_argument("-f", "--file", help="yaml/json experiment file")
    p.add_argument("--algo", "--run", dest="algo",
                   help="registered algorithm name (PPO, IMPALA, ...)")
    p.add_argument("--env", help="environment name")
    p.add_argument("--config", default="{}",
                   help="JSON dict of AlgorithmConfig overrides")
    p.add_argument("--stop-iters", type=int, default=100)
    p.add_argument("--stop-reward", type=float, default=None)
    p.add_argument("--stop-timesteps", type=int, default=None)
    p.add_argument("--checkpoint-dir", default=None)
    args = p.parse_args(argv)

    if args.file:
        import os

        experiments = _load_experiments(args.file)
        out = {}
        for name, exp in experiments.items():
            print(f"== running {name} ==", file=sys.stderr)
            # Per-experiment subdirectory: a shared dir would overwrite
            # earlier experiments' checkpoints.
            ckpt = (os.path.join(args.checkpoint_dir, name)
                    if args.checkpoint_dir else None)
            out[name] = run_experiment(
                exp["run"], exp["env"], exp.get("config"),
                exp.get("stop"), ckpt)
        print(json.dumps(_json_safe(out), default=str))
        return 0
    if not args.algo or not args.env:
        p.error("either -f FILE or both --algo and --env are required")
    stop: Dict[str, Any] = {"training_iteration": args.stop_iters}
    if args.stop_reward is not None:
        stop["episode_reward_mean"] = args.stop_reward
    if args.stop_timesteps is not None:
        stop["num_env_steps_sampled"] = args.stop_timesteps
    metrics = run_experiment(args.algo, args.env,
                             json.loads(args.config), stop,
                             args.checkpoint_dir)
    print(json.dumps(_json_safe(metrics), default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
