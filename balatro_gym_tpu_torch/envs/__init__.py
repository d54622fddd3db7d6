"""Gym-compatible env shells of the port (host loops over the batched
engines on one device): the flagship env's ``BalatroGymEnv``, the 8-card
draw env's ``EightCardDrawGymEnv``, the macro env's ``BalatroMacroGymEnv``
and the small env's ``BalatroSmallGymEnv``."""
from balatro_gym_tpu_torch.envs.balatro_env import (  # noqa: F401
    BalatroEnvValidator,
    BalatroGymEnv,
    make_balatro_env,
)
from balatro_gym_tpu_torch.envs.eight_card_draw import (  # noqa: F401
    EightCardDrawGymEnv,
    make,
)
from balatro_gym_tpu_torch.envs.macro_env import BalatroMacroGymEnv  # noqa: F401
from balatro_gym_tpu_torch.envs.small_env import BalatroSmallGymEnv  # noqa: F401
