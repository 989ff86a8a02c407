"""DAC codec: encoder, residual VQ and decoder."""
