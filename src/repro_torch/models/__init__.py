"""The port's framework-plane models: the Mamba-2 mixer (`mamba`), the
language-model stack (`lm`) and their shared parts (`common`)."""
