"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

* :mod:`.pattern_scan` — multi-byte pattern match masks (query scan).
* :mod:`.digest_sig` — fused Adler-32 partials + n-gram hashes (index
  build).

Each kernel module holds the CUDA launch (sources under ``csrc/``,
built by :mod:`._build`), a plain PyTorch version used for CPU tensors,
and a ``launches`` count. Importing this package builds nothing.
"""
