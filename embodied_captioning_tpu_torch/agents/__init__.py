"""Agent trainers. Importing the subpackage populates the trainer registry
with the exploration baselines; the PPO trainers are not ported yet."""

from . import baselines  # noqa: F401
from .registry import get_trainer, list_trainers  # noqa: F401
