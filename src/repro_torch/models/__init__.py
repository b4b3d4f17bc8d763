"""The LM zoo in PyTorch: configs, layers, attention and the decoder model."""
