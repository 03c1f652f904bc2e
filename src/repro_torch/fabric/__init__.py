"""Flow table, metrics and the batched fleet replay engine."""
