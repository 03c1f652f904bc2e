from repro_torch.traces.batch import TraceBatch, pack, to_device
from repro_torch.traces.loader import load_coflow_benchmark
from repro_torch.traces.synth import fb_like_trace, tiny_trace

__all__ = ["fb_like_trace", "tiny_trace", "load_coflow_benchmark",
           "TraceBatch", "pack", "to_device"]
