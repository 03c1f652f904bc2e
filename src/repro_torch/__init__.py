"""`repro_torch` — the PyTorch/CUDA port of the Saath scheduling plane.

A second package beside the JAX reference `repro`, with the same layout
and names: `repro_torch.api.run(Scenario(engine="torch", ...))` replays
a fleet of coflow traces through the Fig. 7 coordinator tick on an
NVIDIA Hopper card, with the LCoF contention count and the admission /
work-conservation walk as hand-written CUDA kernels (`kernels/csrc/`).
It imports torch and numpy, never jax and nothing of `repro`.
"""
