"""Packed multi-LoRA training: losses, AdamW, synthetic data, the step."""
