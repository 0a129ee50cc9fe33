"""Microscopy image-processing framework on JAX.

A ground-up JAX/XLA rebuild of the capabilities of
GerryDoesStuff/YamImageProcessor (reference mounted at /root/reference):
the preprocessing / segmentation / extraction op families compile to fused
XLA programs over HBM-resident tile batches, the pipeline step graph and
signature cache are preserved API-wise, and gigapixel frames stream through
a mesh-sharded tile runtime instead of per-step NumPy passes.

Subpackages
-----------
core       host-side services: settings, logging, sandboxing, signing,
           recovery/autosave, plugin loading, the application Context.
io         image codecs, metadata sidecars, lazy tiled records.
ops        the op library: pure jittable functions + numpy golden twins.
pipeline   step graph, signature cache, fused-chain compiler.
parallel   device mesh, tile sharding, halo exchange.
models     flagship pipeline chain definitions.
modules    built-in plugin modules (the reference's 8/21/11 op families).
utils      small shared helpers.

Importing this package does NOT import jax; device code paths import it
lazily so the host-only services stay usable in minimal environments.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
