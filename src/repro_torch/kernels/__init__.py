"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

* :mod:`.pattern_scan` — multi-byte pattern match masks (query scan,
  one pattern per launch or one per row for the gateway).
* :mod:`.digest_sig` — fused Adler-32 partials + n-gram hashes (index
  build, derive).
* :mod:`.adler32` — Adler-32 partials (bulk digest verification).
* :mod:`.flash_attention` — blocked GQA attention with an online
  softmax (the LM's prefill and decode steps).

Each kernel module holds the CUDA launch (sources under ``csrc/``,
built by :mod:`._build`), a plain PyTorch version used for CPU tensors,
and a ``launches`` count. Importing this package builds nothing.
"""
