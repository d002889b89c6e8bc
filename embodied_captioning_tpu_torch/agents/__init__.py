"""Agent trainers. Importing the subpackage fills the trainer registry:
the exploration baselines, the PPO goal-exploration trainers and the
remaining trainer family."""

from . import baselines  # noqa: F401
from . import goal_exploration  # noqa: F401
from . import extra_trainers  # noqa: F401
from .registry import get_trainer, list_trainers  # noqa: F401
