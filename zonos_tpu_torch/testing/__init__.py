"""Checks of generated audio."""
