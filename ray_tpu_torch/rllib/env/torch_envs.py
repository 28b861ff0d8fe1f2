"""Batched environments on the device (counterpart of
``ray_tpu/rllib/env/jax_envs.py``; ``train/jax`` became ``train/torch``
the same way).

The JAX envs are written for one instance and ``vmap``-ed; these are
written for the batch: a state is a dict of ``[N, ...]`` tensors on one
device and every step is tensor code with no per-env Python.  Contract:

    reset(num_envs, generator, device) -> (state, obs)
    reset_state(num_envs, generator, device) -> state
    draws(num_envs, generator, device) -> tuple of tensors (often empty)
    step_core(state, action, *draws) -> (state, reward, done)
    step(state, action, generator) -> (state, obs, reward, done, info)

``step_core`` is the dynamics alone, given the random draws of the step
(SpaceInvaders' enemy fire; no other env draws); ``step`` makes those
draws, auto-resets the envs that are done with ``torch.where`` between
the stepped state and a fresh reset of the whole batch (as ``vmap`` of
the JAX step does), then renders.  Draws come from an explicit
``torch.Generator`` on the state's device; the port does not reproduce
JAX's PRNG bits, so parity with the JAX envs means the same transition
from the same state, action and draws.
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
    ``step_core`` and ``_obs``, and ``draws`` if a step is random."""

    def reset(self, num_envs: int, generator: torch.Generator,
              device) -> Tuple[State, torch.Tensor]:
        state = self.reset_state(num_envs, generator, device)
        return state, self._obs(state)

    def draws(self, num_envs: int, generator: torch.Generator,
              device) -> Tuple[torch.Tensor, ...]:
        return ()

    def step(self, state: State, action: torch.Tensor,
             generator: torch.Generator):
        n, device = action.shape[0], action.device
        stepped, reward, done = self.step_core(
            state, action, *self.draws(n, generator, device))
        fresh = self.reset_state(n, generator, device)
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


class StatelessCartPole(CartPole):
    """CartPole with the velocities hidden: obs = ``[x, theta]``, the
    recurrent-policy testbed."""

    obs_dim = 2

    def _obs(self, state: State) -> torch.Tensor:
        return state["core"][:, 0::2]


class Pendulum(TorchEnv):
    """Pendulum-v1 with the torque discretised to 3 bins, -2, 0, +2
    (action 0, 1, 2); 200 steps, reward ``-cost``.  State ``th``,
    ``thdot`` ``[N]`` float32, ``t`` ``[N]`` int32."""

    num_actions = 3
    obs_dim = 3
    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    l = 1.0  # noqa: E741 (the pendulum's length, as in the JAX env)
    max_steps = 200

    def reset_state(self, num_envs: int, generator: torch.Generator,
                    device) -> State:
        def uniform(lo, hi):
            u = torch.rand(num_envs, generator=generator, device=device)
            return u * (hi - lo) + lo

        return {"th": uniform(-math.pi, math.pi),
                "thdot": uniform(-1.0, 1.0),
                "t": torch.zeros(num_envs, dtype=torch.int32, device=device)}

    def _obs(self, state: State) -> torch.Tensor:
        th = state["th"]
        return torch.stack([torch.cos(th), torch.sin(th), state["thdot"]], -1)

    def _torque(self, action: torch.Tensor) -> torch.Tensor:
        """The policy's action as torque; the continuous subclass
        overrides this one hook, so the dynamics stay in one place."""
        return (action.to(torch.float32) - 1.0) * self.max_torque

    def step_core(self, state: State, action: torch.Tensor):
        u = self._torque(action)
        th, thdot = state["th"], state["thdot"]
        # A floored modulo, as jnp's %: the result takes the divisor's sign.
        norm_th = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
        cost = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot = thdot + (3 * self.g / (2 * self.l) * torch.sin(th)
                         + 3.0 / (self.m * self.l ** 2) * u) * self.dt
        thdot = thdot.clamp(-self.max_speed, self.max_speed)
        th = th + thdot * self.dt
        t = state["t"] + 1
        return {"th": th, "thdot": thdot, "t": t}, -cost, t >= self.max_steps


class PendulumContinuous(Pendulum):
    """Pendulum-v1 with its real continuous torque, the SAC family's env:
    ``action`` is ``[N, 1]`` float32, clipped to [-2, 2]."""

    num_actions = None  # continuous
    action_dim = 1
    action_low = -2.0
    action_high = 2.0

    def _torque(self, action: torch.Tensor) -> torch.Tensor:
        return action.to(torch.float32).reshape(action.shape[0]).clamp(
            self.action_low, self.action_high)


def _grid(device, h: int, w: int):
    """Row and column numbers ``[1, h, 1]`` and ``[1, 1, w]`` (int32), for
    one-hot masks of per-env positions."""
    rows = torch.arange(h, dtype=torch.int32, device=device)
    cols = torch.arange(w, dtype=torch.int32, device=device)
    return rows[None, :, None], cols[None, None, :]


def _at(rows, cols, r, c):
    """``[N, H, W]`` one-hot of cell ``(r[n], c[n])``."""
    return (rows == r[:, None, None]) & (cols == c[:, None, None])


class Breakout(TorchEnv):
    """MinAtar-scale Breakout on a 10x10 board: 3 rows of bricks (rows
    1-3), the paddle on the bottom row, a ball moving diagonally.  Actions
    0 noop, 1 left, 2 right; +1 a brick; a missed ball ends the episode; a
    cleared wall respawns.  Observation ``[10, 10, 4]`` float32 planes
    {paddle, ball, trail, bricks}.  Integer state ``[N]`` int32,
    ``bricks`` ``[N, 3, 10]`` bool.  The brick under the ball is read with
    a gather on the flat ``[N, 30]`` wall and cleared with a one-hot
    mask."""

    num_actions = 3
    obs_shape = (10, 10, 4)
    H = W = 10
    max_steps = 1000

    def reset_state(self, num_envs: int, generator: torch.Generator,
                    device) -> State:
        def randint(lo, hi):
            return torch.randint(lo, hi, (num_envs,), generator=generator,
                                 device=device, dtype=torch.int32)

        def full(value):
            return torch.full((num_envs,), value, dtype=torch.int32,
                              device=device)

        ball_x = randint(0, self.W)
        return {
            "paddle_x": full(self.W // 2), "ball_x": ball_x,
            "ball_y": full(4), "dx": randint(0, 2) * 2 - 1, "dy": full(1),
            "last_x": ball_x.clone(), "last_y": full(3),
            "bricks": torch.ones((num_envs, 3, self.W), dtype=torch.bool,
                                 device=device),
            "t": full(0),
        }

    def _obs(self, s: State) -> torch.Tensor:
        rows, cols = _grid(s["ball_x"].device, self.H, self.W)
        paddle = _at(rows, cols, torch.full_like(s["paddle_x"], self.H - 1),
                     s["paddle_x"])
        ball = _at(rows, cols, s["ball_y"], s["ball_x"])
        trail = _at(rows, cols, s["last_y"], s["last_x"])
        # Rows 1..3 of the brick plane hold the wall.
        wall = s["bricks"][:, (rows[0, :, 0] - 1).clamp(0, 2).long()] & (
            (rows >= 1) & (rows <= 3))
        return torch.stack([paddle, ball, trail, wall], -1).to(torch.float32)

    def step_core(self, s: State, action: torch.Tensor):
        i32 = torch.int32
        paddle_x = (s["paddle_x"] - (action == 1).to(i32)
                    + (action == 2).to(i32)).clamp(0, self.W - 1)
        # Side-wall bounce.
        dx = torch.where((s["ball_x"] + s["dx"] < 0)
                         | (s["ball_x"] + s["dx"] > self.W - 1),
                         -s["dx"], s["dx"])
        new_x = s["ball_x"] + dx
        # Ceiling bounce.
        dy = torch.where(s["ball_y"] + s["dy"] < 0, -s["dy"], s["dy"])
        new_y = s["ball_y"] + dy
        # Brick hit: remove it, score, bounce back vertically.  (The column
        # is in range on every state a reset or a step makes; the clamp
        # keeps the gather in bounds on any other.)
        row = (new_y - 1).clamp(0, 2)
        n = new_y.shape[0]
        flat = s["bricks"].reshape(n, -1)
        index = (row * self.W + new_x.clamp(0, self.W - 1)).long()[:, None]
        hit = (new_y >= 1) & (new_y <= 3) & flat.gather(1, index)[:, 0]
        cells = torch.arange(flat.shape[1], device=flat.device)
        flat = flat & ~(hit[:, None] & (cells[None, :] == index))
        reward = hit.to(torch.float32)
        dy = torch.where(hit, -dy, dy)
        new_y = torch.where(hit, s["ball_y"], new_y)
        # Paddle row: a catch bounces the ball up, a miss ends the episode.
        at_bottom = new_y >= self.H - 1
        caught = at_bottom & (new_x == paddle_x)
        dy = torch.where(caught, -1, dy)
        new_y = torch.where(caught, self.H - 2, new_y)
        dead = at_bottom & ~caught
        # A cleared wall respawns, per env.
        flat = flat | ~flat.any(1, keepdim=True)
        t = s["t"] + 1
        done = dead | (t >= self.max_steps)
        state = {"paddle_x": paddle_x, "ball_x": new_x, "ball_y": new_y,
                 "dx": dx, "dy": dy, "last_x": s["ball_x"],
                 "last_y": s["ball_y"], "bricks": flat.view(n, 3, self.W),
                 "t": t}
        return state, reward, done


class SpaceInvaders(TorchEnv):
    """MinAtar-scale Space Invaders on a 10x10 board.  A cannon on the
    bottom row moves and fires (cooldown 4 steps); the alien block
    (rows 1-4, columns 2-7) marches sideways every 4 steps and descends
    one row, turning, when it would leave the board; each step an alive
    alien, drawn uniformly, drops a bullet with probability 0.2.  +1 an
    alien shot; an enemy bullet on the cannon or an alien on the bottom
    row ends the episode; a cleared wave respawns.  Actions 0 noop,
    1 left, 2 right, 3 fire.  Observation ``[10, 10, 4]`` float32 planes
    {cannon, aliens, friendly bullets, enemy bullets}.  State ``aliens``,
    ``fbul``, ``ebul`` ``[N, 10, 10]`` bool, the rest ``[N]`` int32.

    The step's draws are ``fire_u`` ``[N]`` (fire when below 0.2, as
    ``jax.random.bernoulli`` compares its uniform) and ``col_noise``
    ``[N, 100]``: the bullet drops from the alive alien with the largest
    noise, so any i.i.d. continuous noise draws it uniformly (JAX's
    ``categorical`` adds Gumbel noise to logits of 0 and -1e9)."""

    num_actions = 4
    obs_shape = (10, 10, 4)
    H = W = 10
    max_steps = 1000
    move_interval = 4
    shot_cooldown = 4
    enemy_fire_prob = 0.2

    def _initial_aliens(self, num_envs: int, device) -> torch.Tensor:
        aliens = torch.zeros((num_envs, self.H, self.W), dtype=torch.bool,
                             device=device)
        aliens[:, 1:5, 2:8] = True
        return aliens

    def reset_state(self, num_envs: int, generator: torch.Generator,
                    device) -> State:
        def full(value):
            return torch.full((num_envs,), value, dtype=torch.int32,
                              device=device)

        empty = torch.zeros((num_envs, self.H, self.W), dtype=torch.bool,
                            device=device)
        return {"pos": full(self.W // 2),
                "aliens": self._initial_aliens(num_envs, device),
                "dir": full(1), "move_t": full(0), "shot_t": full(0),
                "fbul": empty, "ebul": empty.clone(), "t": full(0)}

    def draws(self, num_envs: int, generator: torch.Generator, device):
        return (torch.rand(num_envs, generator=generator, device=device),
                torch.rand((num_envs, self.H * self.W), generator=generator,
                           device=device))

    def _obs(self, s: State) -> torch.Tensor:
        rows, cols = _grid(s["pos"].device, self.H, self.W)
        cannon = _at(rows, cols, torch.full_like(s["pos"], self.H - 1),
                     s["pos"])
        return torch.stack([cannon, s["aliens"], s["fbul"], s["ebul"]],
                           -1).to(torch.float32)

    @staticmethod
    def _shift_rows(m: torch.Tensor, up: bool) -> torch.Tensor:
        zero = torch.zeros_like(m[:, :1])
        return (torch.cat([m[:, 1:], zero], 1) if up
                else torch.cat([zero, m[:, :-1]], 1))

    @staticmethod
    def _shift_cols(m: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        zero = torch.zeros_like(m[:, :, :1])
        left = torch.cat([m[:, :, 1:], zero], 2)
        return torch.where(right[:, None, None],
                           torch.cat([zero, m[:, :, :-1]], 2), left)

    def step_core(self, s: State, action: torch.Tensor,
                  fire_u: torch.Tensor, col_noise: torch.Tensor):
        i32 = torch.int32
        n = action.shape[0]
        rows, cols = _grid(action.device, self.H, self.W)
        pos = (s["pos"] - (action == 1).to(i32)
               + (action == 2).to(i32)).clamp(0, self.W - 1)
        # Bullets in flight move one cell before a new shot spawns, so a
        # fresh bullet starts at row H-2.
        fbul = self._shift_rows(s["fbul"], up=True)
        ebul = self._shift_rows(s["ebul"], up=False)
        can_fire = (action == 3) & (s["shot_t"] <= 0)
        fbul = fbul | (can_fire[:, None, None]
                       & _at(rows, cols, torch.full_like(pos, self.H - 2),
                             pos))
        shot_t = torch.where(can_fire, self.shot_cooldown,
                             (s["shot_t"] - 1).clamp_min(0))
        # The march: sideways every move_interval steps; at an edge, down
        # one row and turn.
        move_now = s["move_t"] + 1 >= self.move_interval
        aliens = s["aliens"]
        at_edge = torch.where(s["dir"] > 0, aliens[:, :, -1].any(1),
                              aliens[:, :, 0].any(1))
        descend = move_now & at_edge
        new_dir = torch.where(descend, -s["dir"], s["dir"])
        aliens = torch.where(
            descend[:, None, None], self._shift_rows(aliens, up=False),
            torch.where(move_now[:, None, None],
                        self._shift_cols(aliens, s["dir"] > 0), aliens))
        move_t = torch.where(move_now, 0, s["move_t"] + 1)
        # An alive alien, drawn by the noise, drops a bullet.
        flat = aliens.reshape(n, -1)
        fire = (fire_u < self.enemy_fire_prob) & flat.any(1)
        idx = torch.where(flat, col_noise, -math.inf).argmax(1)
        cells = torch.arange(flat.shape[1], device=flat.device)
        ebul = ebul | (fire[:, None] & (cells[None, :] == idx[:, None])
                       ).view(n, self.H, self.W)
        # Friendly bullets hitting aliens: both vanish, +1 each.
        hits = fbul & aliens
        reward = hits.flatten(1).sum(1).to(torch.float32)
        aliens = aliens & ~hits
        fbul = fbul & ~hits
        # Death: an enemy bullet on the cannon, or aliens on the bottom row.
        on_cannon = (ebul[:, self.H - 1]
                     & (cols[0] == pos[:, None])).any(1)
        dead = on_cannon | aliens[:, self.H - 1].any(1)
        # A cleared wave respawns.
        aliens = torch.where(aliens.flatten(1).any(1)[:, None, None], aliens,
                             self._initial_aliens(n, aliens.device))
        t = s["t"] + 1
        done = dead | (t >= self.max_steps)
        state = {"pos": pos, "aliens": aliens, "dir": new_dir,
                 "move_t": move_t, "shot_t": shot_t, "fbul": fbul,
                 "ebul": ebul, "t": t}
        return state, reward, done


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
    "StatelessCartPole-v1": StatelessCartPole,
    "Pendulum-v1": Pendulum,
    "PendulumContinuous-v1": PendulumContinuous,
    "Breakout-MinAtar-v0": Breakout,
    "Breakout-Atari84-v0": Breakout84,
    "SpaceInvaders-MinAtar-v0": SpaceInvaders,
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


def count_episodes(ep_ret, dsum, dcnt, reward, done):
    """Adds one step's rewards to the running returns, and the returns of
    the episodes that ended to the (sum, count) counters."""
    ep_ret = ep_ret + reward
    dsum = dsum + torch.where(done, ep_ret, 0.0).sum()
    dcnt = dcnt + done.sum()
    return torch.where(done, 0.0, ep_ret), dsum, dcnt
