"""Hand-written CUDA kernels and their plain PyTorch versions.

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA tensor; it never falls back from one to the other.
"""
