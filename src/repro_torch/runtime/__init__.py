"""The framework plane's collective scheduler on the port (the
counterpart of `repro.runtime`): gradient buckets as coflows
(`buckets`), their Saath wave plan (`coflow_bridge`) and the wave-ordered
issue of their all-reduces (`overlap`)."""
from repro_torch.runtime import buckets, coflow_bridge, overlap

__all__ = ["buckets", "coflow_bridge", "overlap"]
