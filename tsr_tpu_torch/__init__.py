"""tsr_tpu_torch — the PyTorch/CUDA port of tsr_tpu for NVIDIA Hopper.

The port mirrors the JAX package's module names (``ops/image.py``,
``ops/blur.py``, ``ops/distortions.py``, ``models/``, ``losses.py``,
``train/``, ``eval.py``, ``pipeline.py``) so each module's counterpart is
easy to find. It imports torch and numpy only: nothing of JAX and nothing
of ``tsr_tpu``.

Every TPU kernel of the JAX package has a hand-written CUDA C++ kernel
for ``sm_90a`` here (``kernels/csrc``), built with ``nvcc`` on first use.
Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``;
a CPU tensor takes each kernel's plain PyTorch version, a CUDA tensor
always launches the kernel.
"""
