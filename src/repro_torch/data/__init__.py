"""The port's data pipeline (the counterpart of `repro.data`)."""
from repro_torch.data.pipeline import SyntheticLMData

__all__ = ["SyntheticLMData"]
