"""Loss, metrics and the eval/predict steps."""
