"""PyTorch/CUDA port of us_video_medsam2_tpu for NVIDIA Hopper (sm_90a).

The JAX package beside this one is the reference; this package imports
nothing from it. Public functions keep its NHWC / batch-first layouts so the
two can be compared like with like. Entry points run on ``device="cuda"``
unless the caller asks for the CPU.
"""
