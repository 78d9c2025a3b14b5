"""caitlynrenderer_tpu_torch — the PyTorch/CUDA port of caitlynrenderer_tpu.

The JAX package beside it is the reference every module here is held
against (tests/test_torch_*.py).  This package imports `torch` and never
`jax`, and nothing of the JAX package: it carries its own copies of the
reference's numpy-only host layer (`core/types.py`, `accel/`, `io/`,
`utils/config.py`), each held byte-equal to the original in
tests/test_torch_host.py.

Layout mirrors the reference so each module's counterpart is easy to find:

  core/    datatypes, vector math and camera ray generation on tensors
  accel/   host builders: binary SAH BVH (with its native C++ builder,
           csrc/bvh_builder.cpp, compiled by g++ into build/), SBVH, wide
           groups, CWBVH
  io/      builtin scenes, OBJ/MTL loader, PNG output
  ops/     ray queries: brute-force Möller–Trumbore (csrc/mt_brute.cu), the
           wide-BVH walk (csrc/traverse_mega.cu) and the CWBVH walk
           (csrc/traverse_cw8.cu), each hand-written CUDA kernel behind one
           wrapper with its plain PyTorch twin; the binary-BVH walk in plain
           torch (ops/traverse_bvh.py)
  render/  counter-based sampling, the wavefront integrator, progressive
           accumulation and resolve
  grad/    inverse rendering: parameter overlay, loss, Adam, optimize
  utils/   TOML scene configs, checkpoints, metrics records, NaN checks
  scene.py upload to a device; convert.py carries state and parameters
           across packages

Every function takes its tensors (and so its device) explicitly; there is
no module-level default device.
"""

__version__ = "0.1.0"
