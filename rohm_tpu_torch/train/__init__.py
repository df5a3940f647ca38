"""Training: masking curricula, timestep samplers, AdamW state, steps, checkpoints, loops."""
