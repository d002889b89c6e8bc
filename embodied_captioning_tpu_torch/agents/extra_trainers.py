"""The remaining trainers: frontier v2/v3, curiosity, captioned random
goals, informative trajectories, observe-object with discrete control.

  frontierbaseline-v2/-v3  frontier exploration whose information gain
                           counts caption disagreement too; v3 sends the
                           subgoal again on arrival
  curiosity-v0             goals at map cells where semantic classes were
                           seen, weighted by disagreement
  randomgoalsbaselinecaptioner  random goals; the simulator's
                           ground-truth boxes are captioned and embedded
  informative-trajectories-v0   goal exploration with a JSONL row of
                           training metrics per update
  observeobjectdiscreteactionsbaseline  the scripted orbiter, turning in
                           place at each orbit stop
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig
from ..utils.logging import MetricsLogger
from .baselines import (
    ACTION_LEFT, ACTION_STOP, FrontierBaseline, ObserveObjectBaseline,
    RandomGoalsBaseline, _GoalDirectedTrainer,
)
from .goal_exploration import GoalExplorationTrainer
from .registry import register_trainer


@register_trainer("frontierbaseline-v2")
class FrontierPerceptionBaseline(FrontierBaseline):
    """Frontier exploration informed by the perception stream: the
    frontier information gain adds the caption-disagreement channel to
    the unexplored area, steering the agent toward frontiers near objects
    whose descriptions still disagree."""

    DISAGREEMENT_WEIGHT = 5.0

    def _gain_field(self, maps: np.ndarray) -> np.ndarray:
        unexp = (~(maps[..., 1] > 0.5)).astype(np.float64)
        return unexp + self.DISAGREEMENT_WEIGHT * maps[..., 3]


@register_trainer("frontierbaseline-v3")
class FrontierResendBaseline(FrontierBaseline):
    """On subgoal arrival, send the goal once more before replanning: the
    agent dwells at informative frontiers for extra views."""

    def __init__(self, cfg, **kw):
        super().__init__(cfg, **kw)
        self._resend: List[Optional[Tuple[float, float]]] = [
            None] * self.envs.num_envs

    def new_goal(self, i):
        if self._resend[i] is not None:
            g = self._resend[i]
            self._resend[i] = None
            return g
        g = super().new_goal(i)
        self._resend[i] = g
        return g


@register_trainer("curiosity-v0")
class SemanticCuriosityBaseline(_GoalDirectedTrainer):
    """Semantic curiosity: goals are map cells where semantic classes were
    observed, weighted by their disagreement."""

    def new_goal(self, i):
        env = self.envs.envs[i]
        maps = env.get_and_update_disagreement_map()
        sem = maps[..., 2]
        dis = maps[..., 3]
        score = (sem > 0) * (0.1 + dis)
        ys, xs = np.nonzero(score > 0.05)
        if len(ys) == 0:
            return RandomGoalsBaseline.new_goal(self, i)
        j = int(np.argmax(score[ys, xs]))
        vox = self.cfg.map.voxel_size
        lower = env.map_state.lower.cpu().numpy()
        return (float(xs[j] + 0.5) * vox + lower[0],
                float(ys[j] + 0.5) * vox + lower[2])


@register_trainer("randomgoalsbaselinecaptioner")
class RandomGoalsCaptionerBaseline(RandomGoalsBaseline):
    """Random goals; the detections are the simulator's ground truth, whose
    crops still go through the captioner and the sentence encoder (greedy
    decoding, one env at a time)."""

    def perceive_and_fuse(self, obs, timer=None):
        from ..models.captioner import generate
        from ..models.sbert import encode_tokens
        from ..ops.detections import Detections, expand_boxes
        from ..ops.image import crop_and_resize
        from ..perception import FrameResult

        if self.perceiver is None:
            return None
        cfg = self.cfg
        params = self.perceiver.params
        dets, tok_rows, lp_rows, len_rows = [], [], [], []
        for i, env in enumerate(self.envs.envs):
            single = {k: v[i] for k, v in obs.items()}
            det = env.sim.gt_detections(
                single, max_instances=cfg.detector.max_detections)
            h, w = single["rgb"].shape[:2]
            boxes = expand_boxes(det.boxes, 0.2, h, w)
            crops = crop_and_resize(
                single["rgb"].float(), boxes,
                cfg.captioner.vision.image_size).to(torch.uint8)
            toks, lps, lens = generate(params.captioner, crops, cfg.captioner)
            se_len = cfg.sentence_encoder.max_len
            pad = torch.zeros((toks.shape[0], max(0, se_len - toks.shape[1])),
                              dtype=toks.dtype, device=toks.device)
            emb = encode_tokens(params.sbert,
                                torch.cat([toks, pad], 1)[:, :se_len],
                                cfg.sentence_encoder)
            det = det.replace(embeddings=emb * det.valid[:, None])
            pose = env.camera_pose()
            d_i = single["depth"]
            env.update_pointcloud(det, depth=d_i, pose=pose)
            if hasattr(env, "set_last_frame"):  # KL-reward env variant
                env.set_last_frame(det, d_i, pose)
            dets.append(det)
            tok_rows.append(toks)
            lp_rows.append(lps)
            len_rows.append(lens)
        # a whole FrameResult, so save_step_obs records the ground-truth
        # detections with their captions
        fields = ("boxes", "classes", "scores", "logits", "valid", "masks",
                  "embeddings")
        batched = Detections(**{f: torch.stack([getattr(d, f) for d in dets])
                                for f in fields})
        return FrameResult(
            detections=batched,
            caption_tokens=torch.stack(tok_rows),
            caption_logprobs=torch.stack(lp_rows),
            caption_lengths=torch.stack(len_rows))


@register_trainer("informative-trajectories-v0")
class InformativeTrajectoriesTrainer(GoalExplorationTrainer):
    """Goal exploration with a metrics row per update, written to
    `informative_trajectories.jsonl` under the checkpoint (or
    observation) directory."""

    def __init__(self, cfg: ExperimentConfig, **kw):
        super().__init__(cfg, **kw)
        out = cfg.runtime.checkpoint_dir or cfg.runtime.obs_dir
        self.logger = MetricsLogger(out, run_name="informative_trajectories")

    def _after_update(self, update: int) -> bool:
        # logged inside the loop, so each row carries that update's env
        # rewards
        stop = super()._after_update(update)
        rewards = self.rewards()
        self.logger.log({**self.metrics_log[-1],
                         "mean_env_reward": float(rewards.mean()),
                         "max_env_reward": float(rewards.max())},
                        step=update)
        return stop


@register_trainer("observeobjectdiscreteactionsbaseline")
class ObserveObjectDiscrete(ObserveObjectBaseline):
    """Discrete-action orbiter: the same viewpoints, but it turns in place
    at each orbit stop before moving on."""

    DWELL_STEPS = 3

    def __init__(self, cfg, **kw):
        super().__init__(cfg, **kw)
        self._dwell = np.zeros(self.envs.num_envs, np.int32)

    def actions(self, obs):
        # dwell before the base replans: its actions() takes the next
        # orbit viewpoint as soon as the waypoints run out
        acts = []
        for i in range(self.envs.num_envs):
            if not self._waypoints[i] and 0 < self._dwell[i] < self.DWELL_STEPS:
                self._dwell[i] += 1
                acts.append(ACTION_LEFT)
                continue
            if not self._waypoints[i]:
                self._plan_to(i, self.new_goal(i))
                self._dwell[i] = 0
            a = self._follow(i)
            if a == ACTION_STOP:  # arrived: start the dwell
                self._waypoints[i] = []
                self._dwell[i] = 1
                a = ACTION_LEFT
            acts.append(a)
        return acts

    def on_episode_reset(self, i: int) -> None:
        super().on_episode_reset(i)
        self._dwell[i] = 0
