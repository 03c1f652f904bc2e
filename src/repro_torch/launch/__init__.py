"""Serving entry points of the port: `lm_serve` (LM prefill and decode,
Mamba2-1.3B and StarCoder2-3B), `serve` (`CoflowServer`, the multi-
tenant coflow scheduling front door over `repro_torch.api.SessionPool`),
and the steps they run (`steps`)."""
