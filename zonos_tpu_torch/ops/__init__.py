"""Tensor ops of the port: norms, RoPE, quantization, attention, sampling, kernel wrappers."""
