"""The paper-scale models, as functional PyTorch."""
