"""Global exploration policy network and its action distributions.

A 5-conv CNN over the [S, S, 2] policy maps (disagreement map and
top-down map with the agent's disc), a 72-way orientation embedding, a
512 -> 256 trunk with an optional GRU, a value head and a distribution
head: a diagonal Gaussian over the pre-sigmoid (x, y) map goal, or a
categorical over discrete actions.

Parameters are a plain dict in the JAX package's tree (same key names;
conv kernels OIHW, as `params.from_jax` stores them). Types follow the
JAX package: the convs take and give bf16, the orientation embedding
joins in float32, the dense layers give bf16, so `value` and `mean` are
bf16 and the Gaussian log-probs float32. Sampling draws from an explicit
`torch.Generator`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..config import PolicyConfig
from ..models.common import dense, dense_init, randn
from ..models.detector import conv, conv_init


class PolicyOutput(NamedTuple):
    value: torch.Tensor        # [B]
    mean: torch.Tensor         # [B, A] (gaussian mean or categorical logits)
    log_std: torch.Tensor      # [A] (gaussian only)
    rnn_state: Optional[torch.Tensor] = None  # [B, 256] updated GRU state


def init_policy(g: torch.Generator, cfg: PolicyConfig, num_actions: int = 2,
                device="cuda") -> dict:
    """Random weights with the JAX `init_policy`'s shapes and scales,
    drawn from `g` (the numbers differ from jax.random's)."""
    chans = [cfg.input_channels, 32, 64, 128, 64, 32]
    convs = [conv_init(g, 3, chans[i], chans[i + 1], device)
             for i in range(5)]
    # 5 stride-2 SAME convs: the side is ceil-divided at each
    feat_side = cfg.map_size
    for _ in range(5):
        feat_side = -(-feat_side // 2)
    flat = 32 * feat_side * feat_side
    extra = {"gru": init_gru(g, 256, device)} if cfg.recurrent else {}
    return extra | {
        "convs": convs,
        "orient_emb": randn(g, (cfg.orientation_bins, 8), device, 0.02),
        "fc1": dense_init(g, flat + 8, 512, device),
        "fc2": dense_init(g, 512, 256, device),
        "value": dense_init(g, 256, 1, device, scale=0.01),
        "act": dense_init(g, 256, num_actions, device, scale=0.01),
        "log_std": torch.full((num_actions,), -1.0, device=device),
    }


def init_gru(g: torch.Generator, dim: int, device) -> dict:
    return {"wx": dense_init(g, dim, 3 * dim, device),
            "wh": dense_init(g, dim, 3 * dim, device)}


def gru_step(p: dict, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One GRU cell step: gates in bf16, the new state in float32 (the
    float32 state `h` joins the bf16 gates)."""
    gx = dense(p["wx"], x)
    gh = dense(p["wh"], h)
    d = h.shape[-1]
    r = torch.sigmoid(gx[..., :d] + gh[..., :d])
    z = torch.sigmoid(gx[..., d:2 * d] + gh[..., d:2 * d])
    n = torch.tanh(gx[..., 2 * d:] + r * gh[..., 2 * d:])
    return (1 - z) * n + z * h


def policy_forward(params: dict, maps: torch.Tensor,
                   orientation: torch.Tensor,
                   rnn_state: Optional[torch.Tensor] = None) -> PolicyOutput:
    """maps [B, H, W, C] float, orientation [B] int bin index. With a
    recurrent policy and `rnn_state` [B, 256], a GRU refines the trunk
    features."""
    x = maps
    for cv in params["convs"]:
        x = F.relu(conv(cv, x, stride=2))
    b = x.shape[0]
    x = x.reshape(b, -1)
    o = params["orient_emb"][orientation.long()]
    x = torch.cat([x.float(), o], dim=-1)
    x = F.relu(dense(params["fc1"], x))
    x = F.relu(dense(params["fc2"], x))
    h = None
    if rnn_state is not None and "gru" in params:
        x = h = gru_step(params["gru"], rnn_state, x)
    value = dense(params["value"], x)[:, 0]
    mean = dense(params["act"], x)
    return PolicyOutput(value, mean, params["log_std"], h)


# ---------------------------------------------------------------------------
# distributions
# ---------------------------------------------------------------------------


def gaussian_sample(g: torch.Generator, mean: torch.Tensor,
                    log_std: torch.Tensor) -> torch.Tensor:
    noise = torch.randn(mean.shape, generator=g, dtype=torch.float32,
                        device=mean.device)
    return mean + torch.exp(log_std) * noise


def gaussian_log_prob(action: torch.Tensor, mean: torch.Tensor,
                      log_std: torch.Tensor) -> torch.Tensor:
    var = torch.exp(2 * log_std)
    lp = -0.5 * (torch.square(action - mean) / var
                 + 2 * log_std + math.log(2 * math.pi))
    return torch.sum(lp, dim=-1)


def gaussian_entropy(log_std: torch.Tensor) -> torch.Tensor:
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))


def categorical_sample(g: torch.Generator, logits: torch.Tensor
                       ) -> torch.Tensor:
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=g)[:, 0].to(torch.int32)


def categorical_log_prob(action: torch.Tensor, logits: torch.Tensor
                         ) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, action[..., None].long())[..., 0]


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(torch.exp(logp) * logp, dim=-1))


def act(params: dict, g: Optional[torch.Generator], maps: torch.Tensor,
        orientation: torch.Tensor, deterministic: bool = False,
        categorical: bool = False,
        rnn_state: Optional[torch.Tensor] = None):
    """Choose an action: (action, raw_action, log_prob, value), and the new
    GRU state last when `rnn_state` is given. Gaussian actions are
    squashed to [0, 1]^2 by a sigmoid (a map goal); `raw_action` is the
    pre-squash value PPO evaluates. `g` may be None when
    `deterministic`."""
    out = policy_forward(params, maps, orientation, rnn_state)
    if categorical:
        a = (torch.argmax(out.mean, -1).to(torch.int32) if deterministic
             else categorical_sample(g, out.mean))
        lp = categorical_log_prob(a, out.mean)
        res = (a, a, lp, out.value)
    else:
        raw = out.mean if deterministic else gaussian_sample(g, out.mean,
                                                             out.log_std)
        lp = gaussian_log_prob(raw, out.mean, out.log_std)
        res = (torch.sigmoid(raw), raw, lp, out.value)
    return res + (out.rnn_state,) if rnn_state is not None else res


def evaluate_actions(params: dict, maps: torch.Tensor,
                     orientation: torch.Tensor, raw_actions: torch.Tensor,
                     categorical: bool = False,
                     rnn_state: Optional[torch.Tensor] = None):
    """(log_probs, entropy, values) of stored pre-squash actions, for the
    PPO update; `rnn_state` (recurrent policies) the GRU states stored
    with them."""
    out = policy_forward(params, maps, orientation, rnn_state)
    if categorical:
        lp = categorical_log_prob(raw_actions, out.mean)
        ent = categorical_entropy(out.mean)
    else:
        lp = gaussian_log_prob(raw_actions, out.mean, out.log_std)
        ent = gaussian_entropy(out.log_std)
    return lp, ent, out.value
