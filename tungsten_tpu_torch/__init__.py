"""tungsten_tpu_torch — the PyTorch / CUDA port of tungsten_tpu.

The same renderer as the JAX package beside it, module for module:
  utils/       math + stateless counter RNG (pcg4d, scrambled Sobol')
  io/          host-side readers/writers (wo3, obj, pfm, rgbe, vdb)
  scene/       JSON parse -> SceneDesc -> FlatScene (tensors) + BVH
  bsdf/        material eval/sample/pdf over a parameter table
  media/       phase functions, transmittance laws, voxel / analytic
               density grids (optical depth and its inverse)
  cameras/     ray generation, reconstruction filters, tonemaps
  ops/         ray traversal: the CUDA wave kernels (csrc/) and their
               plain PyTorch versions
  integrators/ wavefront path tracer, checkpoint / resume files
  render.py    the render loop, adaptive sampling, output buffers
  cli.py       the `tungsten` CLI;  server.py  the render server
  tools/       hdrmanip, scenemanip, obj2json, json2xml, the NFOR
               denoiser, and mxubench (the tensor-core leaf kernel)

Entry points (`flatten_scene`, `render`, `wave_intersect`, the CLI, the
server, `mxubench`, `nfor_denoise`) run on the CUDA device unless the
caller passes device="cpu"; they raise when CUDA is absent instead of
falling back.  The package never imports JAX nor anything of
`tungsten_tpu`.
"""

__version__ = "0.1.0"

from tungsten_tpu_torch.scene.parse import load_scene  # noqa: F401
