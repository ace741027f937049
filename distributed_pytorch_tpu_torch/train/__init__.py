"""Training on one card or over a data-parallel world (parallel/): state
and optimizer, the train and eval steps, verified checkpoints, throughput
metrics and the loop."""
