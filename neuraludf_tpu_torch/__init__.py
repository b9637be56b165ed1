"""neuraludf_tpu_torch — the PyTorch / CUDA port of ``neuraludf_tpu`` for
one NVIDIA H100 (sm_90a).

The JAX package stays the reference; this package imports nothing of it.
Module names follow the JAX package's so each counterpart is easy to find:

  config, hocon  — typed config and the .conf loader (copies)
  data/          — IDR scene loading, ray sampling, PNG I/O, image resize,
                   synthetic scenes
  nets/          — the distance, colour and background networks
  ops/           — the fused distance-field kernels and their plain versions
  csrc/          — CUDA C++ sources of those kernels
  render/        — the occlusion-aware UDF renderer and its samplers
  losses/        — colour, patch and mask losses
  train/         — Adam, schedules, the training step, the runner (training,
                   validation renders, meshes) and the depth colour map
  mesh/          — MeshUDF: grid queries on the device, the host C++
                   marching cubes (``mesh/csrc/``), cleanup, PLY I/O
  eval/          — Chamfer / F-score evaluation, DTU mesh cleaning, and their
                   command lines (eval_dtu, clean_dtu_mesh)
  utils/         — a minimal HDF5 writer, a line-plot rasteriser
  convert        — JAX params and checkpoints into the port
  cli            — the command line (every mode of the JAX package's)

Entry points run on ``cuda:<gpu>`` unless the caller passes ``device="cpu"``.
"""
