"""torchvision-layout state_dict <-> JAX-package variables."""
