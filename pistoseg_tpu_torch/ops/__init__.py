"""Tensor ops (resize, normalisation), host codecs and CUDA kernels."""
