"""Host-side audio: WAV I/O and polyphase resampling (copies of the JAX package's)."""
