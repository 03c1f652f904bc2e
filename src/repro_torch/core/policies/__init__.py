"""The policy registry of the port's event-driven host plane.

The port's own copy of `repro.core.policies`: the numpy host reference
simulator's policies (`fabric.simulator.Simulator` replays a
`FlowTable` under one), with their kernel work — the contention count of
Saath and LWTF, the whole tick of `saath-torch` — on the policy's
`device`.
"""
from repro_torch.core.policies.aalo import Aalo, CoordinatedFifo
from repro_torch.core.policies.base import Policy
from repro_torch.core.policies.offline import LWTF, SCF, SRTF, VarysSEBF
from repro_torch.core.policies.saath import Saath
from repro_torch.core.policies.saath_torch import SaathTorch
from repro_torch.core.policies.uctcp import UCTCP

REGISTRY = {
    "saath": Saath,
    "saath-torch": SaathTorch,
    "aalo": Aalo,
    "fifo": CoordinatedFifo,
    "scf": SCF,
    "srtf": SRTF,
    "lwtf": LWTF,
    "varys-sebf": VarysSEBF,
    "uc-tcp": UCTCP,
}

# Policies whose Fig. 7 tick also exists as the batched tensor plane
# (core.coordinator / fabric.engine): "saath" and its tick-at-a-time
# wrapper resolve to the SAME algorithm on both engines, so
# `repro_torch.api.Scenario(policy="saath")` is engine-portable; every
# other registry entry is host-only.
TORCH_ENGINE_POLICIES = frozenset({"saath", "saath-torch"})


def available(engine: str = "numpy") -> list:
    """Policy names runnable on `engine` ('numpy' = host reference
    simulator, 'torch' = batched tensor fleet engine), sorted."""
    names = REGISTRY if engine == "numpy" else TORCH_ENGINE_POLICIES
    return sorted(names)


def make_policy(name: str, params, *, device=None, **kw) -> Policy:
    """Instantiate a registered policy whose kernel work runs on
    `device` (None = CUDA, raising without a card; "cpu" = the plain
    versions); unknown names raise with the available list."""
    try:
        cls = REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; available: "
            f"{', '.join(sorted(REGISTRY))}") from None
    return cls(params, device=device, **kw)


def resolve_policy(name: str, engine: str) -> str:
    """Validate `name` for `engine` and return its canonical name.

    Both planes resolve through the one REGISTRY: on the torch engine
    the saath family maps onto the batched coordinator (canonically
    "saath"); host-only policies raise with the torch-capable list,
    unknown names raise with the full list.
    """
    if name not in REGISTRY:
        raise ValueError(
            f"unknown policy {name!r}; available: "
            f"{', '.join(sorted(REGISTRY))}")
    if engine == "torch":
        if name not in TORCH_ENGINE_POLICIES:
            raise ValueError(
                f"policy {name!r} has no batched implementation; "
                f"engine='torch' supports: "
                f"{', '.join(sorted(TORCH_ENGINE_POLICIES))} "
                f"(use engine='numpy' for the host reference)")
        return "saath"
    return name


__all__ = ["Policy", "Saath", "SaathTorch", "Aalo", "CoordinatedFifo",
           "SCF", "SRTF", "LWTF", "VarysSEBF", "UCTCP", "REGISTRY",
           "make_policy", "TORCH_ENGINE_POLICIES", "available",
           "resolve_policy"]
