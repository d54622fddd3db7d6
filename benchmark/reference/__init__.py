"""The benchmark's plain reference: plain PyTorch, independent of the port.

A frozen copy of the port's plain paths (the flagship env's step, reset,
observation rows and sampler on packed rows, the Threefry hash and the
game's tables) and a plain PPO update written out on them (``ppo.py``).
Nothing here imports the port or JAX; the benchmark hands both sides the
same inputs and judges the port's outputs against what this package
computes from those inputs.
"""
