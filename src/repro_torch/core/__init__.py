"""Adapter metadata and packed-LoRA application."""
