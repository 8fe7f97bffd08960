"""ResNet38d trunk, the ReviseNet (RFM) and the flax weight bridge."""
