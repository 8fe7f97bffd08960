"""Configuration, manifests and checkpoints."""
