"""Dense GQA decoder: layers, stack, model."""
