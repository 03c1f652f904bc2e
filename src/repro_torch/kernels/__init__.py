"""The port's hand-written Hopper kernels (`csrc/`), their ctypes
wrappers, their plain PyTorch versions (`ref`) and the device dispatch
(`ops`). Nothing here builds or loads a kernel at import time."""
