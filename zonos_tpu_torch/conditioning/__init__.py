"""Conditioning: the text front end, make_cond_dict and the prefix conditioner.

The text modules are the port's own copies of the JAX package's jax-free
front end (same phonemes for every language); ``native_g2p`` builds the
repo's C++ rule engines into the port's build directory.
"""
