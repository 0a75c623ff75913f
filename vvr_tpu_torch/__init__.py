"""vvr_tpu_torch — the PyTorch/CUDA port of vvr_tpu for one NVIDIA H100.

Entry point: `render.renderer.Renderer(WorldConfig, RenderConfig,
device=...).render(camera)`. The hot passes are hand-written CUDA kernels
(csrc/, built and loaded by kernels.py) with a plain torch version beside
each; CUDA tensors launch the kernel, CPU tensors run the plain version.
Importing the package imports neither jax nor vvr_tpu.
"""
