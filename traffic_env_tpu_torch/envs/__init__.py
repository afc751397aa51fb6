from .env import EnvState, localize_reward
from .rollout import BatchedEnv, bind_schedule, make_batched_env, \
    random_rollout
from .structs import SimState, SpawnSchedule

__all__ = ["BatchedEnv", "EnvState", "SimState", "SpawnSchedule",
           "bind_schedule", "localize_reward", "make_batched_env",
           "random_rollout"]
