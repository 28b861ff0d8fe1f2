"""`rllib evaluate` CLI (counterpart of ``ray_tpu/rllib/evaluate.py``;
reference: rllib/evaluate.py): restore an algorithm from a checkpoint
directory (the port's ``air.Checkpoint`` of a torch state dict, as
``train.py`` writes it) and run greedy in-env episodes.

Usage::

    python -m ray_tpu_torch.rllib.evaluate /tmp/ckpt --algo PPO \\
        --env CartPole-v1 --steps 2000
"""
from __future__ import annotations

import argparse
import json


def evaluate_checkpoint(checkpoint_path: str, algo: str, env: str,
                        config: dict | None = None,
                        num_steps: int = 1000) -> dict:
    from ray_tpu_torch.air.checkpoint import Checkpoint
    from ray_tpu_torch.rllib import get_algorithm_config
    from ray_tpu_torch.rllib.train import apply_config

    cfg = get_algorithm_config(algo).environment(env)
    apply_config(cfg, config or {})
    algorithm = cfg.build()
    algorithm.load_checkpoint(Checkpoint.from_directory(checkpoint_path))
    out = algorithm.evaluate(num_steps=num_steps)
    algorithm.stop()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rllib evaluate", description=__doc__)
    p.add_argument("checkpoint", help="checkpoint directory")
    p.add_argument("--algo", "--run", dest="algo", required=True)
    p.add_argument("--env", required=True)
    p.add_argument("--config", default="{}",
                   help="JSON dict of AlgorithmConfig overrides")
    p.add_argument("--steps", type=int, default=1000)
    args = p.parse_args(argv)
    out = evaluate_checkpoint(args.checkpoint, args.algo, args.env,
                              json.loads(args.config), args.steps)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
