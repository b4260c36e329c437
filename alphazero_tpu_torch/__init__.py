"""PyTorch + CUDA port of ``alphazero_tpu`` for NVIDIA Hopper GPUs.

Mirrors the JAX package's layout (``games/splendor``, ``models``, ``ops``,
``search``, ``train``, ``utils``).  It imports ``torch`` and numpy only and
never the JAX package: what it needs from there it keeps as its own copy.
Entry points run on ``device="cuda"`` unless the caller passes another
device (the CPU tests pass ``device="cpu"``)."""
