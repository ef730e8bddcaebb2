"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``csrc/`` holds the CUDA C++ sources (built by ``_build`` with ``nvcc`` for
``sm_90a`` and bound with ``ctypes``); ``recflash_sls``,
``dot_interaction`` and ``flash_attention`` are their wrappers, each with a
count of its launches; ``ref`` holds the plain versions and ``ops`` the
public ops.
"""
