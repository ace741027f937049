"""Token data for training: the synthetic token file and the step-keyed
batch loader (numpy, no native sampler)."""
