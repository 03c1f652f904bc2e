"""The port's framework-plane models: the attention mixers (`attention`:
GQA and MLA), the Mamba-2 mixer (`mamba`), the MoE FFN (`moe`), the
language-model stack (`lm`) and their shared parts (`common`)."""
