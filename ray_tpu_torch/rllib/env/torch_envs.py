"""Batched environments on the device (counterpart of
``ray_tpu/rllib/env/jax_envs.py``; ``train/jax`` became ``train/torch``
the same way).

The JAX envs are written for one instance and ``vmap``-ed; these are
written for the batch: a state is a dict of ``[N, ...]`` tensors on one
device and every step is tensor code with no per-env Python.  Contract:

    reset(num_envs, generator, device) -> (state, obs)
    reset_state(num_envs, generator, device) -> state
    step_core(state, action) -> (state, reward, done)
    step(state, action, generator) -> (state, obs, reward, done, info)

``step_core`` is the dynamics alone; ``step`` auto-resets the envs that
are done with ``torch.where`` between the stepped state and a fresh reset
of the whole batch (as ``vmap`` of the JAX step does), then renders.
Reset draws come from an explicit ``torch.Generator`` on the state's
device; the port does not reproduce JAX's PRNG bits, so parity with the
JAX envs means the same transition from the same state and action.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

State = Dict[str, torch.Tensor]


def _where(done: torch.Tensor, a: State, b: State) -> State:
    """Per env: ``a`` where ``done``, else ``b`` (leading dim N)."""
    out = {}
    for k, v in b.items():
        mask = done.view(done.shape + (1,) * (v.dim() - 1))
        out[k] = torch.where(mask, a[k], v)
    return out


class TorchEnv:
    """What every env shares: ``reset`` renders ``reset_state``; ``step``
    is ``step_core`` with auto-reset.  Subclasses define ``reset_state``,
    ``step_core`` and ``_obs``."""

    def reset(self, num_envs: int, generator: torch.Generator,
              device) -> Tuple[State, torch.Tensor]:
        state = self.reset_state(num_envs, generator, device)
        return state, self._obs(state)

    def step(self, state: State, action: torch.Tensor,
             generator: torch.Generator):
        stepped, reward, done = self.step_core(state, action)
        fresh = self.reset_state(done.shape[0], generator, done.device)
        state = _where(done, fresh, stepped)
        return state, self._obs(state), reward, done, {}


class CartPole(TorchEnv):
    """CartPole-v1 dynamics (500-step limit, ±2.4 position, ±12° angle).
    ``state["core"]`` is ``[N, 4]`` float32 (x, x_dot, theta, theta_dot),
    ``state["t"]`` ``[N]`` int32."""

    num_actions = 2
    obs_dim = 4

    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    length = 0.5
    force_mag = 10.0
    tau = 0.02
    theta_threshold = 12 * 2 * math.pi / 360
    x_threshold = 2.4
    max_steps = 500

    def reset_state(self, num_envs: int, generator: torch.Generator,
                    device) -> State:
        core = torch.rand((num_envs, 4), generator=generator,
                          device=device) * 0.1 - 0.05
        return {"core": core,
                "t": torch.zeros(num_envs, dtype=torch.int32, device=device)}

    def _obs(self, state: State) -> torch.Tensor:
        return state["core"]

    def step_core(self, state: State, action: torch.Tensor):
        x, x_dot, theta, theta_dot = state["core"].unbind(-1)
        force = torch.where(action == 1, self.force_mag, -self.force_mag)
        costheta, sintheta = torch.cos(theta), torch.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot ** 2 * sintheta
                ) / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta ** 2
                           / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        core = torch.stack([x, x_dot, theta, theta_dot], -1)
        t = state["t"] + 1
        done = ((x.abs() > self.x_threshold)
                | (theta.abs() > self.theta_threshold)
                | (t >= self.max_steps))
        reward = torch.ones_like(x)
        return {"core": core, "t": t}, reward, done


class Breakout84(TorchEnv):
    """Pixel Breakout at Atari resolution: ``[84, 84, 4]`` uint8 frames
    (channels paddle, ball, trail, bricks), an 8x2-px paddle moving ±3 px,
    a 2x2-px ball, a wall of 6 x 12 bricks of 3x7 px on rows 12..29;
    +1 a brick, a missed ball ends the episode, a cleared wall respawns.
    Integer state ``[N]`` int32, ``bricks`` ``[N, 6, 12]`` bool.

    Rendering uses masks, as the JAX env does: each sprite is the outer
    product of a row band and a column band, and the brick channel gathers
    each pixel's brick cell.  The brick under the ball is read and cleared
    through a flat index into the ``[N, 72]`` wall."""

    num_actions = 3
    obs_shape = (84, 84, 4)
    H = W = 84
    PW = 8
    PADDLE_ROW = 82
    BRICK_TOP = 12
    BRICK_H = 3
    BRICK_W = 7
    ROWS, COLS = 6, 12
    max_steps = 2500

    def __init__(self):
        self._grids = {}

    def _grid(self, device):
        """Per-device constants: pixel rows and columns, each pixel's flat
        brick cell (clipped), the brick band, and the 72 cell numbers.
        Made once per device, so that no step copies from the host."""
        device = torch.device(device)
        if device not in self._grids:
            rows = torch.arange(self.H, dtype=torch.int32, device=device)
            cols = torch.arange(self.W, dtype=torch.int32, device=device)
            brow = torch.div(rows - self.BRICK_TOP, self.BRICK_H,
                             rounding_mode="floor").clamp(0, self.ROWS - 1)
            bcol = torch.div(cols, self.BRICK_W,
                             rounding_mode="floor").clamp(0, self.COLS - 1)
            cell = (brow[:, None] * self.COLS + bcol[None, :]).reshape(-1)
            band = ((rows >= self.BRICK_TOP)
                    & (rows < self.BRICK_TOP + self.ROWS * self.BRICK_H))
            cells = torch.arange(self.ROWS * self.COLS, device=device)
            self._grids[device] = (rows, cols, cell.long(), band[:, None],
                                   cells)
        return self._grids[device]

    def reset_state(self, num_envs: int, generator: torch.Generator,
                    device) -> State:
        def randint(lo, hi):
            return torch.randint(lo, hi, (num_envs,), generator=generator,
                                 device=device, dtype=torch.int32)

        bx = randint(8, self.W - 10)
        k = randint(0, 4)
        dx = k - 2 + (k >= 2).to(torch.int32)  # one of -2, -1, 1, 2
        px = randint(0, self.W - self.PW)

        def full(value):
            return torch.full((num_envs,), value, dtype=torch.int32,
                              device=device)

        return {
            "px": px, "bx": bx, "by": full(40), "dx": dx, "dy": full(2),
            "lx": bx.clone(), "ly": full(38),
            "bricks": torch.ones((num_envs, self.ROWS, self.COLS),
                                 dtype=torch.bool, device=device),
            "t": full(0),
        }

    def _obs(self, s: State) -> torch.Tensor:
        rows, cols, cell, band, _ = self._grid(s["px"].device)
        r = rows[None, :, None]
        c = cols[None, None, :]

        def sprite(top, left, h, w):
            top, left = top[:, None, None], left[:, None, None]
            return (r >= top) & (r < top + h) & (c >= left) & (c < left + w)

        paddle = sprite(torch.full_like(s["px"], self.PADDLE_ROW), s["px"],
                        2, self.PW)
        ball = sprite(s["by"], s["bx"], 2, 2)
        trail = sprite(s["ly"], s["lx"], 2, 2)
        n = s["bricks"].shape[0]
        wall = (s["bricks"].reshape(n, -1)[:, cell].view(n, self.H, self.W)
                & band)
        stacked = torch.stack([paddle, ball, trail, wall], -1)
        return stacked.to(torch.uint8) * 255

    def step_core(self, s: State, action: torch.Tensor):
        i32 = torch.int32
        px = (s["px"] - 3 * (action == 1).to(i32)
              + 3 * (action == 2).to(i32)).clamp(0, self.W - self.PW)
        # Side walls bounce (the ball is 2 px wide).
        dx = torch.where((s["bx"] + s["dx"] < 0)
                         | (s["bx"] + s["dx"] > self.W - 2), -s["dx"], s["dx"])
        new_x = (s["bx"] + dx).clamp(0, self.W - 2)
        # Ceiling bounce.
        dy = torch.where(s["by"] + s["dy"] < 0, -s["dy"], s["dy"])
        new_y = (s["by"] + dy).clamp(0, self.H - 2)
        # Brick collision on the landing cell (floor division, as jnp's //).
        in_band = ((new_y >= self.BRICK_TOP)
                   & (new_y < self.BRICK_TOP + self.ROWS * self.BRICK_H))
        row = torch.div(new_y - self.BRICK_TOP, self.BRICK_H,
                        rounding_mode="floor").clamp(0, self.ROWS - 1)
        col = torch.div(new_x + 1, self.BRICK_W,
                        rounding_mode="floor").clamp(0, self.COLS - 1)
        n = new_y.shape[0]
        flat = s["bricks"].reshape(n, -1)
        index = (row * self.COLS + col).long()[:, None]
        hit = in_band & flat.gather(1, index)[:, 0]
        _, _, _, _, cells = self._grid(flat.device)
        flat = flat & ~(hit[:, None] & (cells[None, :] == index))
        reward = hit.to(torch.float32)
        dy = torch.where(hit, -dy, dy)
        new_y = torch.where(hit, s["by"], new_y)
        # Paddle band: a catch bounces up, a miss ends the episode.
        at_bottom = new_y >= self.PADDLE_ROW - 1
        caught = at_bottom & (new_x + 1 >= px) & (new_x <= px + self.PW - 1)
        dy = torch.where(caught, -dy.abs(), dy)
        new_y = torch.where(caught, self.PADDLE_ROW - 3, new_y)
        dead = at_bottom & ~caught
        # A cleared wall respawns, per env.
        flat = flat | ~flat.any(1, keepdim=True)
        t = s["t"] + 1
        done = dead | (t >= self.max_steps)
        state = {"px": px, "bx": new_x, "by": new_y, "dx": dx, "dy": dy,
                 "lx": s["bx"], "ly": s["by"],
                 "bricks": flat.view(n, self.ROWS, self.COLS), "t": t}
        return state, reward, done


REGISTRY = {
    "CartPole-v1": CartPole,
    "Breakout-Atari84-v0": Breakout84,
}


def make_torch_env(name: str):
    if name not in REGISTRY:
        raise ValueError(f"unknown torch env {name!r}; have {list(REGISTRY)}")
    return REGISTRY[name]()


def vector_reset(env, generator: torch.Generator, num_envs: int, device):
    """Batched reset: (states, obs) with leading [num_envs]."""
    return env.reset(num_envs, generator, device)


def vector_step(env, states: State, actions: torch.Tensor,
                generator: torch.Generator):
    """Batched step with auto-reset: (states, obs, reward, done, info)."""
    return env.step(states, actions, generator)
