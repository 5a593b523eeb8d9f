"""Pallas kernels compiled for the GPU through Triton (`ils_kernels`)."""
