"""Entry points of the port: `lm_serve` (LM prefill and decode),
`serve` (`CoflowServer`, the multi-tenant coflow scheduling front door
over `repro_torch.api.SessionPool`), `train` (LM training with
checkpoints and the coflow plan of its gradient buckets), and the steps
they run (`steps`)."""
