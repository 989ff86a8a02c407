"""Transformer backbone and the Zonos model handle."""
