"""Packed-LoRA kernels: hand-written CUDA for Hopper and their plain versions."""
