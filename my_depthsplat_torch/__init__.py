"""my_depthsplat_torch — DepthSplat in PyTorch with hand-written CUDA kernels
for an NVIDIA H100 (sm_90a).

A port of ``my_depthsplat_tpu`` (the JAX/Pallas reference, which stays
unchanged beside it). This package imports ``torch``, numpy and the standard
library only. Layout mirrors the reference package:

- ``geometry``  — camera projection / ray math
- ``gaussians`` — pixel-aligned Gaussian parameterization + SH
- ``render``    — tile rasterizer: projection, tile expansion (CUDA kernel),
  binning, tile composite (CUDA kernel)
- ``models``    — DINOv2 ViT, PromptDA and UniMatch depth branches, encoder,
  decoder, the bf16 precision policy
- ``ops``       — resizes, the plane sweep and the CUDA build/load helper
- ``convert``   — flax parameter trees -> the port's modules
- ``csrc``      — CUDA C++ kernel sources, built with nvcc at first use
- ``train``     — losses, LPIPS, optimizer, the training step, checkpoints
- ``data``      — the re10k reader, view samplers, shims, the batch loader
- ``eval``      — metrics, the benchmarker and the test-mode runner
- ``config``, ``main`` — YAML configurations and the test-mode CLI

Public entry points keep the reference's channels-last layout: images
(B, V, H, W, 3), gaussians (B, G, ...). Internal modules are NCHW. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; with CUDA
tensors the render wrappers launch their kernels, with CPU tensors they run
the plain PyTorch versions.
"""

__version__ = "0.1.0"
