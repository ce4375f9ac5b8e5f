"""PyTorch/CUDA port of the persistent-memory I/O primitives' training
persistence stack.

The JAX package (``repro``) is the reference; this package imports
nothing of it and nothing of JAX. It keeps its own copies of the numpy
modules it needs (``core``, ``pool``, ``io``, ``cache``, ``tier``,
``persistence.wal``) and ports the checkpoint manager and its four
device kernels to PyTorch tensors and hand-written CUDA (``kernels``).
Entry points run on the card unless the caller asks for the CPU.
"""
