"""Entropy coding: the device chain (K4, K8, K9) and the host coder."""
