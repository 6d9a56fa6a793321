"""``repro_torch`` — the FastWARC archive-analytics system on PyTorch + CUDA.

A port of :mod:`repro` (JAX/Pallas) to one NVIDIA Hopper GPU. The host
layers (WARC streams and parsing, the CDX index, the query engine) are
kept as copies; every Pallas kernel on the ported path is a hand-written
CUDA C++ kernel for ``sm_90a`` (:mod:`repro_torch.kernels`), built with
``nvcc`` at first use and bound with ``ctypes``.

Public entry points take a ``device`` argument that defaults to
``"cuda"``; the CPU runs only when the caller passes ``device="cpu"``,
where each kernel wrapper uses its plain PyTorch version.

This package never imports ``jax`` or any module of :mod:`repro`.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
