"""Training: PolySGD with parameter groups, the train state, the trainer."""
