"""clraytracer_tpu_torch — the ray tracer in PyTorch with hand-written CUDA
kernels for the NVIDIA H100 (sm_90a).

A port of ``clraytracer_tpu`` (JAX/Pallas on a TPU), which stays beside it
as the reference. This package imports neither JAX nor the reference
package: it keeps its own copies of the host-side code (configuration,
scene builder, BVH and cluster builders, procedural textures).

Two paths are ported. The default forward frame (``render.render_frame``)
on all-procedural scenes is one launch of the fused frame kernel
(csrc/render.cu), which shares its traversal with the hit-record kernel
(csrc/trace.cu). The differentiable step (``diff.image_loss_and_grads``)
traces with the hit-record kernel and gathers each hit's triangle row with
csrc/gather.cu, whose scatter-add is its backward. Public entry points run
on the CUDA card unless the caller passes ``device="cpu"``, where the
kernels' plain PyTorch versions run instead. Scenes come from the named
procedural recipes or from files (OBJ/MTL, ``.clm``, ``.clsnap.npz``;
``scene/``); the reference tracers (``ops/trace_ref.py``,
``ops/trace_wavefront.py``) are plain torch, chosen by name in
``render.TRACERS`` and taken for scenes without cluster tables. Above them
sit the reference's application layer: ``engine.Engine`` (the frame
loop), ``raycast`` (picking), ``bench`` (the benchmark, timed by CUDA
events) and the two viewers in ``tools/``. ``parallel/`` spreads the
frame's rows and the scene's instances over the ranks of a
``torch.distributed`` group (NCCL, one rank per card, or gloo), with the
data-parallel training step and ``cli sweep``. ``entry`` holds the
entry points (``entry()``: the default frame on the flagship scene;
``dryrun_multichip(n)``: the multi-device path over n ranks it starts
itself), and ``tools/profile_step.py`` and ``tools/grads_breakdown.py``
profile the differentiable step on the card.
"""

__version__ = "0.1.0"

from clraytracer_tpu_torch.config import CameraConfig, RenderConfig  # noqa: F401
