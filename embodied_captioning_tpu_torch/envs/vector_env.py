"""Vectorized environment manager with an asynchronous step.

When every env uses the stock EmbodiedEnv step/observe over a RaycastSim,
the whole batch renders in memory-bounded chunked calls
(`sim.render_batch_chunked`); envs that override step/observe are stepped
one by one.

Episodes auto-reset on done: the obs returned for a finished step is the
NEXT episode's first observation, and the done flag marks the boundary.

`step_async` hands the batch step to one worker thread, which advances the
agents on the host and launches the next frame's render while the caller
reads back the current frame and writes observations. The worker launches
on a CUDA stream of its own (on the caller's stream the caller's copies
would queue behind the render): at dispatch the worker's stream waits for
the caller's, `step_wait` makes the caller's stream wait for the worker's,
and the tensors handed back are recorded on the caller's stream so their
memory is not reused under it. Because the worker mutates env state while
the caller records frame t, dispatch snapshots each env's (pose, step,
episode): `snapshot_at` is what observation recording must read.
"""

from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import ExperimentConfig
from .env import EmbodiedEnv
from .sim import RaycastSim, Scene, render_batch_chunked


def _tensors(obj) -> List[torch.Tensor]:
    """The tensors in a (nested) step result."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    return []


class VectorEnv:
    def __init__(self, cfg: ExperimentConfig,
                 num_envs: Optional[int] = None, device="cuda"):
        from .registry import make_env

        self.cfg = cfg
        self.device = torch.device(device)
        n = num_envs or cfg.runtime.num_envs
        self.envs: List[EmbodiedEnv] = [
            make_env(cfg.runtime.env_name, cfg, env_id=i, device=self.device)
            for i in range(n)]
        # one worker: env stepping is serialized with itself (envs are
        # stateful), but overlaps with the caller's readbacks and writes
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="vecenv")
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._pending: Dict[int, Future] = {}
        self._batch_future: Optional[Future] = None
        self._snap: List[Optional[Dict[str, Any]]] = [None] * n
        # with a dict, the worker adds its seconds per dispatch (host work
        # and its stream's work, synchronised) under "worker"
        self.timings: Optional[Dict[str, float]] = None

    @property
    def num_envs(self) -> int:
        return len(self.envs)

    # -- RPC ----------------------------------------------------------------
    def call_at(self, index: int, method: str, kwargs: Optional[dict] = None):
        return getattr(self.envs[index], method)(**(kwargs or {}))

    def call(self, method: str, kwargs_list: Optional[List[dict]] = None):
        kwargs_list = kwargs_list or [{}] * self.num_envs
        return [self.call_at(i, method, kw)
                for i, kw in enumerate(kwargs_list)]

    # -- dispatch-time state snapshots --------------------------------------
    def _take_snapshot(self, index: int) -> None:
        env = self.envs[index]
        self._snap[index] = {
            "position": env.get_agent_position(),
            "step": env.get_step(),
            "episode_id": env.get_episode_id(),
        }

    def snapshot_at(self, index: int) -> Dict[str, Any]:
        """Pose/step/episode of env `index` as of the LAST step dispatch.
        Observation recorders must read this, not the live env getters:
        the worker thread mutates agent state while the caller writes
        frame t."""
        if self._snap[index] is None:  # nothing dispatched: live is safe
            self._take_snapshot(index)
        return self._snap[index]

    # -- the worker ------------------------------------------------------
    def _submit(self, fn: Callable, *args) -> Future:
        """Run fn(*args) on the worker thread; on the card, on the worker's
        stream, after the work the caller's stream has queued so far."""
        timings = self.timings
        queued = (torch.cuda.current_stream(self.device).record_event()
                  if self._stream is not None else None)

        def work():
            t0 = time.perf_counter()
            if queued is None:
                out = fn(*args)
            else:
                with torch.cuda.stream(self._stream):
                    self._stream.wait_event(queued)
                    out = fn(*args)
                    if timings is not None:
                        self._stream.synchronize()
                    out = out, self._stream.record_event()
            if timings is not None:
                timings["worker"] = (timings.get("worker", 0.0)
                                     + time.perf_counter() - t0)
            return out

        return self._pool.submit(work)

    def _result(self, fut: Future):
        """The worker's result, ready for the caller's stream."""
        if self._stream is None:
            return fut.result()
        out, done = fut.result()
        caller = torch.cuda.current_stream(self.device)
        caller.wait_event(done)
        for t in _tensors(out):
            if t.is_cuda:
                t.record_stream(caller)
        return out

    @staticmethod
    def _step_one(env: EmbodiedEnv, action: int):
        obs, r, d, info = env.step(int(action))
        if d:  # auto-reset: the next episode's first obs
            obs = env.reset()
        return obs, r, d, info

    def async_step_at(self, index: int, action: int) -> None:
        """Dispatch one env's step to the worker thread."""
        self._take_snapshot(index)
        self._pending[index] = self._submit(self._step_one, self.envs[index],
                                            int(action))

    def wait_step_at(self, index: int):
        fut = self._pending.pop(index, None)
        if fut is None:
            raise RuntimeError(
                f"wait_step_at({index}) without a matching async_step_at: "
                "the env would advance a frame the caller never requested")
        return self._result(fut)

    # -- batched stepping --------------------------------------------------
    def _batched_render_ok(self) -> bool:
        """The batched render needs the stock step/observe (subclasses may
        add obs channels or per-step work) over RaycastSims."""
        return all(type(e).step is EmbodiedEnv.step
                   and type(e).step_state is EmbodiedEnv.step_state
                   and type(e).observe is EmbodiedEnv.observe
                   and isinstance(e.sim, RaycastSim) for e in self.envs)

    def _step_all(self, actions: Sequence[int]):
        if self._batched_render_ok():
            rdi = [env.step_state(int(a))
                   for env, a in zip(self.envs, actions)]
            scenes = Scene(*(torch.stack(xs) for xs in
                             zip(*(e.sim.scene for e in self.envs))))
            poses = torch.stack([e.camera_pose() for e in self.envs])
            s = self.cfg.sensors
            out = render_batch_chunked(scenes, poses, s.height, s.width,
                                       s.hfov_deg, s.max_depth)
            rewards = np.asarray([r for r, _, _ in rdi], np.float32)
            dones = np.asarray([d for _, d, _ in rdi], bool)
            infos = [i for _, _, i in rdi]
            if dones.any():  # auto-reset: done rows get the new episode
                obs_list = [{k: v[i] for k, v in out.items()}
                            for i in range(self.num_envs)]
                for i in np.flatnonzero(dones):
                    obs_list[int(i)] = self.envs[int(i)].reset()
                return self._stack(obs_list), rewards, dones, infos
            return out, rewards, dones, infos
        outs = [self._step_one(env, a)
                for env, a in zip(self.envs, actions)]
        obs = self._stack([o[0] for o in outs])
        rewards = np.asarray([o[1] for o in outs], np.float32)
        dones = np.asarray([o[2] for o in outs], bool)
        infos = [o[3] for o in outs]
        return obs, rewards, dones, infos

    def step(self, actions: Sequence[int]):
        """Synchronous batch step on the caller's stream; returns (obs
        dict, rewards, dones, infos)."""
        return self._step_all(actions)

    def step_async(self, actions: Sequence[int]) -> None:
        """Dispatch the whole batch step to the worker thread. Pair with
        `step_wait`. Snapshots every env's pose/step first (see
        `snapshot_at`)."""
        assert self._batch_future is None, "step_async already pending"
        for i in range(self.num_envs):
            self._take_snapshot(i)
        self._batch_future = self._submit(self._step_all, list(actions))

    def step_wait(self):
        assert self._batch_future is not None, "no step_async pending"
        fut, self._batch_future = self._batch_future, None
        return self._result(fut)

    def reset(self):
        return self._stack([env.reset() for env in self.envs])

    def observe(self):
        return self._stack([env.observe() for env in self.envs])

    @staticmethod
    def _stack(obs_list: List[Dict[str, torch.Tensor]]):
        return {k: torch.stack([o[k] for o in obs_list])
                for k in obs_list[0]}

    def close(self) -> None:
        self._pool.shutdown(wait=False)
