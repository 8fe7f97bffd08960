"""PyTorch/CUDA port of ``pistoseg_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module
layout for the parts that have been ported (stage 4: RFM training;
stage 4b: RFM refinement inference).  It imports ``torch``, numpy, scipy
and PIL, never JAX or ``pistoseg_tpu``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; asking for ``cuda`` without a card is an error.
"""
