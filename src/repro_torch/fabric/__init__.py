"""Flow table, metrics, fabric models and the batched fleet replay engine."""
