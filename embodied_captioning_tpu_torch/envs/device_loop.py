"""The fused exploration loop: K env + perception steps per call.

Agent state update (pose and collision), raycast render and the
perception program run back to back on the device for a window of K
steps; the host reads nothing back inside the window. Every tensor
carries a leading env axis E.

`step_agents` mirrors RaycastSim.step / RaycastSim._blocked (collision =
rejected forward move), and `camera_poses` mirrors
AgentState.camera_matrix (yaw about +Y, camera at agent + [0, 0.88, 0]).

Two rollouts:
  rollout_perception   step -> render -> perceive, checksum only: the
                       throughput workload.
  rollout_fused        additionally fuses detections and embeddings into
                       each env's voxel map and emits the per-step
                       disagreement rewards.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig, SimConfig
from ..mapping import voxel_map as V
from ..ops.image import resize_bilinear
from ..perception import PerceptionParams, perceive
from .sim import (ACTION_FORWARD, ACTION_LEFT, ACTION_RIGHT, AGENT_HEIGHT,
                  AGENT_RADIUS, Scene, render_batch)


class LoopState(NamedTuple):
    """Per-env agent state, [E]-vectorised, on the device."""

    x: torch.Tensor      # [E] f32
    z: torch.Tensor      # [E] f32
    yaw: torch.Tensor    # [E] f32 radians about +Y (yaw=0 faces -Z)
    collided: torch.Tensor  # [E] bool: the last forward move was blocked


def states_from_sims(sims) -> Tuple[Scene, LoopState]:
    """Stack host RaycastSims into a batched Scene + LoopState on the
    sims' device."""
    scenes = Scene(*(torch.stack(xs) for xs in zip(*(s.scene for s in sims))))
    dev = scenes.box_min.device

    def f32(vals):
        return torch.tensor(np.asarray(vals, np.float32), device=dev)

    state = LoopState(
        x=f32([s.agent.x for s in sims]),
        z=f32([s.agent.z for s in sims]),
        yaw=f32([s.agent.yaw for s in sims]),
        collided=torch.zeros(len(sims), dtype=torch.bool, device=dev),
    )
    return scenes, state


def blocked(scenes: Scene, x: torch.Tensor, z: torch.Tensor,
            scene_size: float) -> torch.Tensor:
    """Mirror of RaycastSim._blocked for E envs (x, z [E]).

    Boxes whose top is at or below 0.05 m (floor) or whose bottom is above
    the agent's head don't block; otherwise the agent's radius-expanded
    (x, z) footprint against the box footprint decides. Out of the room
    is blocked."""
    mn, mx = scenes.box_min, scenes.box_max                  # [E, B, 3]
    relevant = (scenes.valid & (mx[..., 1] > 0.05)
                & (mn[..., 1] <= AGENT_HEIGHT + 0.4))
    xb, zb = x[:, None], z[:, None]
    inside = ((xb > mn[..., 0] - AGENT_RADIUS)
              & (xb < mx[..., 0] + AGENT_RADIUS)
              & (zb > mn[..., 2] - AGENT_RADIUS)
              & (zb < mx[..., 2] + AGENT_RADIUS))
    oob = ~((x > AGENT_RADIUS) & (x < scene_size - AGENT_RADIUS)
            & (z > AGENT_RADIUS) & (z < scene_size - AGENT_RADIUS))
    return (relevant & inside).any(dim=-1) | oob


def step_agents(scenes: Scene, state: LoopState, actions: torch.Tensor,
                sim_cfg: SimConfig) -> LoopState:
    """One discrete action per env: 1 forward `forward_step` meters
    (rejected on collision), 2 turn left, 3 turn right, 0/other no-op.
    `collided` is True where a forward move was blocked."""
    fs = sim_cfg.forward_step
    turn = float(np.deg2rad(sim_cfg.turn_angle_deg))
    nx = state.x - torch.sin(state.yaw) * fs
    nz = state.z - torch.cos(state.yaw) * fs
    hit = blocked(scenes, nx, nz, sim_cfg.scene_size)
    fwd = actions == ACTION_FORWARD
    move = fwd & ~hit
    return LoopState(
        x=torch.where(move, nx, state.x),
        z=torch.where(move, nz, state.z),
        yaw=state.yaw + turn * ((actions == ACTION_LEFT).float()
                                - (actions == ACTION_RIGHT).float()),
        collided=fwd & hit,
    )


def camera_poses(state: LoopState) -> torch.Tensor:
    """[E, 4, 4] T_world_cam: R_y(yaw), camera at agent + [0, 0.88, 0]."""
    c, s = torch.cos(state.yaw), torch.sin(state.yaw)
    T = torch.zeros(state.x.shape[0], 4, 4, device=state.x.device)
    T[:, 0, 0], T[:, 0, 2] = c, s
    T[:, 1, 1] = 1.0
    T[:, 2, 0], T[:, 2, 2] = -s, c
    T[:, 0, 3], T[:, 1, 3], T[:, 2, 3] = state.x, AGENT_HEIGHT, state.z
    T[:, 3, 3] = 1.0
    return T


def _render_scan(scenes: Scene, poses: torch.Tensor, cfg: ExperimentConfig
                 ) -> Dict[str, torch.Tensor]:
    """The loop's batch render at the configured sensor geometry. The
    raycast kernel keeps no per-box tensor, so all envs go in one call."""
    s = cfg.sensors
    return render_batch(scenes, poses, s.height, s.width, s.hfov_deg,
                        s.max_depth, "onehot")


@torch.no_grad()
def rollout_perception(params: PerceptionParams, scenes: Scene,
                       state: LoopState, actions: torch.Tensor,
                       cfg: ExperimentConfig):
    """K loop steps: step agents -> render -> perceive.

    Args:
      actions: [K, E] i32.
    Returns (state', checksum [] f32, valid_detections [] i64).
    """
    actions = torch.as_tensor(actions).to(state.x.device)
    checksum = torch.zeros((), device=state.x.device)
    n_valid = torch.zeros((), dtype=torch.int64, device=state.x.device)
    for acts in actions:
        state = step_agents(scenes, state, acts, cfg.sim)
        rgb = _render_scan(scenes, camera_poses(state), cfg)["rgb"]
        r = perceive(params, rgb, cfg)
        d = r.detections
        checksum = (checksum + d.boxes.float().sum() + d.scores.sum()
                    + r.caption_tokens.sum() + d.embeddings.sum())
        n_valid = n_valid + d.valid.sum()
    return state, checksum, n_valid


@torch.no_grad()
def rollout_fused(params: PerceptionParams, scenes: Scene, state: LoopState,
                  map_states: V.VoxelMapState, actions: torch.Tensor,
                  cfg: ExperimentConfig,
                  timings: Optional[Dict[str, float]] = None):
    """K full loop steps: step -> render -> perceive -> voxel-fuse ->
    disagreement reward, with the per-env voxel maps ([E]-batched
    VoxelMapState) carried through and updated in place.

    The frame integrated at each step is the one rendered after the step,
    with its depth brought down to the detector's mask raster.

    With `timings` (a dict), the device is synchronised after each part
    of a step and the seconds are added under "step_render", "perceive"
    and "fuse_reward"; without it nothing synchronises.

    Returns (state', map_states', rewards [K, E], collided [K, E]). The
    reward is the post-fusion disagreement sum times `ppo.reward_scale`
    per env per step.
    """
    actions = torch.as_tensor(actions).to(state.x.device)
    clock = time.perf_counter()

    def lap(key: str) -> None:
        nonlocal clock
        if timings is not None:
            if state.x.is_cuda:
                torch.cuda.synchronize()
            now = time.perf_counter()
            timings[key] = timings.get(key, 0.0) + now - clock
            clock = now

    rewards, collided = [], []
    for acts in actions:
        state = step_agents(scenes, state, acts, cfg.sim)
        poses = camera_poses(state)
        obs = _render_scan(scenes, poses, cfg)
        rgb, depth = obs["rgb"], obs["depth"]
        lap("step_render")
        det = perceive(params, rgb, cfg).detections
        lap("perceive")
        mh, mw = det.masks.shape[-2:]
        if depth.shape[-1] != mw:  # the detector's paste raster
            stride = depth.shape[-1] // mw
            if stride * mw == depth.shape[-1]:
                depth = depth[:, ::stride, ::stride]
            else:
                depth = resize_bilinear(depth[..., None], mh, mw)[..., 0]
        map_states = V.integrate_frame(
            map_states, depth, poses, det.masks, det.classes, det.logits,
            det.embeddings, det.valid, cfg.map,
            hfov_deg=cfg.sensors.hfov_deg, min_depth=cfg.sensors.min_depth,
            max_depth=cfg.sensors.max_depth)
        rewards.append(V.disagreement_reward(map_states, cfg.map,
                                             scale=cfg.ppo.reward_scale))
        collided.append(state.collided)
        lap("fuse_reward")
    return state, map_states, torch.stack(rewards), torch.stack(collided)


def make_action_plan(num_steps: int, num_envs: int,
                     pattern: str = "explore", seed: int = 0) -> np.ndarray:
    """[K, E] i32 action plans for a window. "explore": mostly forward
    with periodic turns (1 + (i % 3)); "random": uniform
    forward/left/right."""
    if pattern == "explore":
        k = np.arange(num_steps)[:, None]
        return np.broadcast_to(1 + (k % 3),
                               (num_steps, num_envs)).astype(np.int32)
    rng = np.random.default_rng(seed)
    return rng.integers(1, 4, size=(num_steps, num_envs)).astype(np.int32)
