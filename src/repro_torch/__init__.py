"""RecFlash on PyTorch and CUDA (NVIDIA Hopper).

A port of ``repro`` (JAX on a TPU), which stays the reference. This package
imports torch and numpy only: never jax, and nothing of ``repro``. Where it
needs one of the reference's numpy modules it keeps its own copy.

Every entry point takes a ``device`` argument that defaults to ``"cuda"`` and
raises when no card is present, unless the caller asks for ``"cpu"``
(``repro_torch.device.resolve_device``). The two Pallas kernels of the
reference are CUDA C++ kernels here (``repro_torch.kernels``); on a CPU
tensor their wrappers run the kernels' plain PyTorch versions.
"""
