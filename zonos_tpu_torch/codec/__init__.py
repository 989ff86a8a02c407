"""DAC codec (decoder half)."""
