"""Training on one device: state and optimizer, the train and eval steps,
verified checkpoints, throughput metrics and the loop."""
