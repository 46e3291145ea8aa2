"""PackSELL on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

It imports neither JAX nor ``repro``: the host code it shares with the
reference is copied into :mod:`repro_torch.core`. Entry points run on the
GPU unless the caller passes ``device="cpu"``, which runs each kernel's
plain PyTorch version instead.
"""
