"""PyTorch + CUDA port of ``balatro_gym_tpu``.

The JAX package beside this one is the reference each module here is held
against (tests/test_torch_*.py). This package imports torch and numpy only.
Its layout mirrors the reference: ``core/`` (cards, constants, pow tables,
named streams), ``ops/`` (Threefry RNG, joker tables, hand evaluation,
scoring, the CUDA kernels' wrappers and plain versions; the sources in
``csrc/``), ``engine/`` (the sim and flagship engines, shop and pack
logic), ``envs/`` (the Gym shells), ``train/`` (PPO, A2C, DQN, behaviour
cloning, the search, evaluation) and ``utils/``.
"""
