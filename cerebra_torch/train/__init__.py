"""Training: the optimizer, the step and the feature-distillation recipe."""
