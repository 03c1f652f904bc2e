"""`repro_torch` — the PyTorch/CUDA port of Saath.

A second package beside the JAX reference `repro`, with the same layout
and names: `repro_torch.api.run(Scenario(engine="torch", ...))` replays
a fleet of coflow traces through the Fig. 7 coordinator tick on an
NVIDIA Hopper card, `repro_torch.api.SaathSession` and `SessionPool`
run that tick online for one tenant or many on one device-resident
slab, and `repro_torch.launch.lm_serve.ServeSession` serves Mamba2-1.3B
and StarCoder2-3B there. The LCoF contention count, the admission /
work-conservation walk, the max-min fill and the SSD chunked scan are
hand-written CUDA kernels (`kernels/csrc/`). It imports torch and
numpy, never jax and nothing of `repro`.
"""
