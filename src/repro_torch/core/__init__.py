"""Spec, analog numerics and functional simulator of one FPCA layer."""
