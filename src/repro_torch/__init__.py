"""PyTorch/CUDA port of the joint partitioning & placement system.

Counterpart of ``repro`` module for module (``core``, ``models``,
``kernels``, ``serving``, ``edgesim``, ``launch``, ``configs``), for an
NVIDIA Hopper card.  The port imports ``torch`` and ``numpy`` only.
Entry points take a ``device`` that defaults to ``"cuda"`` and raise when no
card is present unless ``"cpu"`` is asked for.
"""
