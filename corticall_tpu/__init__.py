"""corticall_tpu — an accelerator-native linked multi-color de Bruijn graph framework.

A from-scratch reimplementation of the capabilities of mcveanlab/Corticall
(a Java de novo mutation caller over Cortex graphs), redesigned around
batched device kernels written in JAX:

- k-mers are 2-bit-packed uint32 word tensors (struct-of-arrays), never strings,
  on the hot path (reference round-trips through ASCII constantly; we do not).
- random access is a vectorized open-addressing hash table (reference:
  binary search over an mmap, CortexGraph.java:272-317).
- walks/DFS advance thousands of frontiers per fused device step
  (reference: one vertex at a time, TraversalEngine.java:241-319).
- the mosaic alignment HMM (Tesserae) is a vectorized log-space DP scanned
  over query positions (reference: scalar 3D loops, Tesserae.java:188-341).
- multi-device scaling shards the k-mer hash table over a jax Mesh with
  all_to_all lookup routing (reference: none in-process; Cromwell scatter).

File-format compatibility (.ctx, .ctp.gz/.ctp.bgz) is preserved exactly for
interop and bit-identical golden tests.
"""

import os as _os

import jax as _jax

# Persistent XLA compilation cache, so a run after the first skips the
# compiles of the walk, banded-SW and Tesserae programs.  A location given in
# JAX_COMPILATION_CACHE_DIR (which JAX reads itself) wins; otherwise the cache
# sits at a fixed path inside the checkout.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))

__version__ = "0.1.0"
