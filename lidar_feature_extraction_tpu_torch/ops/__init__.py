"""Hand-written kernels and the plain tensor code around them."""
