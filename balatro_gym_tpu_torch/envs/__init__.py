"""Gym-compatible env shells of the port (host loops over the engine on one
device): the flagship env's ``BalatroGymEnv``."""
from balatro_gym_tpu_torch.envs.balatro_env import (  # noqa: F401
    BalatroEnvValidator,
    BalatroGymEnv,
    make_balatro_env,
)
