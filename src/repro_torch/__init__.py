"""PyTorch and CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The package mirrors ``src/repro/``'s layout so each module's JAX
counterpart is easy to find, but it imports neither JAX nor anything of
``repro``: what it needs from there it keeps as its own copy.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``;
on a CPU tensor each hand-written kernel's wrapper runs the kernel's
plain PyTorch version instead.
"""
