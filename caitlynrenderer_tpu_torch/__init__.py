"""caitlynrenderer_tpu_torch — the PyTorch/CUDA port of caitlynrenderer_tpu.

The JAX package beside it is the reference every module here is held
against (tests/test_torch_*.py).  This package imports `torch` and never
`jax`; it shares the JAX-free host layer of the reference as it is
(`core/types.py`, `io/`, `accel/{bvh,wide}.py`, `utils/config.py`).

Layout mirrors the reference so each module's counterpart is easy to find:

  core/    vector math and camera ray generation on tensors
  ops/     ray queries: brute-force Möller–Trumbore (csrc/mt_brute.cu) and
           the wide-BVH walk (csrc/traverse_mega.cu), each hand-written
           CUDA kernel behind one wrapper with its plain PyTorch twin
  render/  counter-based sampling, the wavefront integrator, progressive
           accumulation and resolve
  scene.py upload to a device; convert.py carries state across packages

Every function takes its tensors (and so its device) explicitly; there is
no module-level default device.
"""

__version__ = "0.1.0"
