"""Single-image 128^3 shape reconstruction (counterpart of ``bench.py:94-211``).

``build`` makes the full-size shape model with seeded random weights;
``reconstruct`` runs image -> latents -> K/V caches -> coarse-to-fine grid
decode through the fused decoder kernel -> 10k area-uniform surface points
in world coordinates. ``reconstruct_batch`` does the same for a batch, in
either decode posture of the evaluation: coarse-to-fine, or the dense grid
(also through the kernel) with the dense sampler. ``reconstruct_with_attn``
decodes the dense grid through the plain decoder, which also gives the
z-averaged attention maps of the visual dumps. A decoder that the
kernel is not built for (a narrower one, as in small training runs) takes
the plain decode instead, as the JAX engine's XLA decoder does.

Random init proxy (bench.py:113-139): BCE-trained occupancy decoders
saturate (|logit| ~ O(10) away from the surface) while random-init logits
hover near 0, which would mark every coarse cell as near-surface. Scaling
the logits by ``sharpen`` (25) keeps the architecture, FLOPs and zero-level
set. A trained checkpoint sets ``sharpen`` to 1. A random field is also
smooth and nearly flat, so its zero level either misses the grid or marks
most coarse cells active; :func:`calibrate_random_field` sets its output
layer so that it has a trained field's share of inside points and count of
active cells.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from zeroshape_tpu_torch import resolve_device
from zeroshape_tpu_torch.config import full_opt, synthetic_image
from zeroshape_tpu_torch.metrics.eval3d import (
    _select_active_cells,
    coarse_lattice,
    get_dense_3D_grid,
    occupancy_grid,
    occupancy_grid_hierarchical,
    occupancy_grid_with_attn,
    resolve_hier_capacity,
)
from zeroshape_tpu_torch.models import resolve_compute_dtype
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
from zeroshape_tpu_torch.ops.implicit_kernel import fused_decode, kernel_supported, pack_decoder_params
from zeroshape_tpu_torch.ops.marching_cubes import sample_surface_points, sample_surface_points_cells
from zeroshape_tpu_torch.weights import init_like_flax

VOX_RES = 128
CAPACITY = 4096  # refined-cell budget, the JAX engine default at vox 128
NUM_POINTS = 10000
SHARPEN = 25.0
RANGE = (-1.5, 1.5)
FACTOR = 4
MARGIN = 0.45  # a coarse corner within 0.5 +- MARGIN marks its cells active
# active coarse cells of trained fields at vox 128: 760-2,533 over 74 test
# images for each of two checkpoints, medians 1,289 and 1,638 (docs/ROUND5.md:84-85)
ACTIVE_TARGET = 1600
# a ball whose surface crosses about ACTIVE_TARGET coarse cells fills about a
# tenth of the 32^3 coarse cells
INSIDE = 0.1


@dataclass
class ReconModel:
    graph: ShapeGraph
    packed: dict | None  # the kernel's packed decoder weights (CUDA only)
    sharpen: float
    device: torch.device
    # False: decode plainly even where K1 is built for the decoder (the
    # benchmark's A/B and FLOP count, as the JAX bench's use_fused=False)
    fused: bool = True

    def repack(self):
        """Re-pack the kernel weights after the graph's weights changed: on
        CUDA, for a decoder the kernel is built for; any other decoder keeps
        ``packed`` None and decodes plainly (:func:`decode_points`)."""
        supported = self.device.type == "cuda" and uses_kernel(self)
        self.packed = pack_decoder_params(self.graph.impl_network) if supported else None
        return self


def uses_kernel(model):
    """Whether :func:`decode_points` decodes ``model``'s points through K1."""
    return getattr(model, "fused", True) and kernel_supported(model.graph.impl_network)


def sync(device):
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def decode_points(model, caches, pts):
    """Logits ``[B, T]`` of ``pts [B, T, 3]`` against the caches of B samples,
    chosen by the decoder's shapes as the JAX engine chooses by
    ``fused_supported`` (``shape_engine.py:193-202``): K1, one launch a
    sample, for a decoder the kernel is built for; any other decoder, or a
    model with ``fused`` off, runs the plain ``Implicit.decode`` in its
    compute dtype, one call for the batch, counted in
    ``decode_points.plain_decodes``."""
    impl = model.graph.impl_network
    if uses_kernel(model):
        return torch.stack([
            fused_decode(impl, [(k[b : b + 1], v[b : b + 1]) for k, v in caches], pts[b], model.packed)
            for b in range(pts.shape[0])
        ])
    decode_points.plain_decodes += 1
    return impl.decode(caches, pts)[0]


decode_points.plain_decodes = 0


def build(opt=None, device=None, seed=0):
    """The shape model with seeded random weights, on ``device`` (None -> cuda)."""
    device = resolve_device(device)
    opt = opt or full_opt()
    graph = ShapeGraph.from_opt(opt, dtype=resolve_compute_dtype(opt, device))
    init_like_flax(graph, seed)
    graph = graph.to(device).eval()
    return ReconModel(graph, None, SHARPEN, device).repack()


def _inputs(batch, device):
    return {
        k: torch.as_tensor(batch[k], dtype=torch.float32, device=device)
        for k in ("rgb_input_map", "mask_input_map")
    }


def calibrate_random_field(model, batch, target=ACTIVE_TARGET, vox_res=VOX_RES, rng=RANGE):
    """Set the random decoder's output layer so that ``batch``'s field looks
    like a trained one on the coarse lattice: its zero level encloses the
    top ``INSIDE`` share of the lattice points, and it is steep enough that
    at most ``target`` cells are active.

    For random weights only. A random decoder's field is smooth across the
    whole grid and varies by less than the sharpened margin, so with the
    zero level anywhere in it most coarse cells are active, far more than a
    trained field's few cells along the surface. The layer's bias moves the
    zero level (the shift) and a power-of-two gain on the layer, exact in
    bf16, steepens the field. The gain is the least of 1, 2, ..., 2^12 that
    brings the count to ``target``, or 2^12 if none does. Returns
    ``(shift, gain, n_active)``.
    """
    graph = model.graph
    with torch.inference_mode():
        caches = graph.encode_latents(graph.encode_image(_inputs(batch, model.device)))
        pts = coarse_lattice(vox_res, rng, FACTOR, model.device)
        n = vox_res // FACTOR + 1
        logits = decode_points(model, caches, pts[None])[0].reshape(n, n, n)
        shift = float(torch.quantile(logits.flatten().float(), 1.0 - INSIDE))
        for gain in (2.0**k for k in range(13)):
            occ = torch.sigmoid(model.sharpen * gain * (logits - shift))
            count = int(_select_active_cells(occ, MARGIN, 1)[2])
            if count <= target:
                break
    out = graph.impl_network.output_layer
    with torch.no_grad():
        out.weight.mul_(gain)
        out.bias.sub_(shift).mul_(gain)
    model.repack()
    return shift, gain, count


def synthetic_setup(device=None, opt=None, seed=0):
    """The full-size main path on seeded random weights (seed 0) and a
    synthetic image drawn from ``seed`` (224^2, or ``opt.H``), calibrated and
    warmed up once; ``opt`` picks another architecture than
    ``config.full_opt()``'s (e.g. ``config.encoders_opt()``).

    Returns ``(model, batch, generator, calibration)``: the generator of the
    surface draws is seeded by ``seed``, the calibration is
    :func:`calibrate_random_field`'s ``(shift, gain, n_active)``.
    """
    model = build(opt, device=device, seed=0)
    rgb, mask = synthetic_image(model.graph.H, seed=seed)
    batch = {"rgb_input_map": rgb, "mask_input_map": mask}
    calibration = calibrate_random_field(model, batch)
    generator = torch.Generator(device=model.device).manual_seed(seed)
    reconstruct(model, batch, generator)
    sync(model.device)
    return model, batch, generator, calibration


def time_reconstructions(model, batch, generator, reps=5):
    """Host-clock seconds of ``reps`` reconstructions, each ending in a sync."""
    seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        reconstruct(model, batch, generator)
        sync(model.device)
        seconds.append(time.perf_counter() - t0)
    return seconds


@torch.inference_mode()
def reconstruct_batch(
    model,
    batch,
    generator=None,
    vox_res=VOX_RES,
    capacity=CAPACITY,
    num_points=NUM_POINTS,
    rng=RANGE,
    hier=True,
):
    """Images -> surface samples, in either decode posture of ``_recon_fn``
    (``shape_engine.py:142-319``).

    ``hier=True`` is the coarse-to-fine decode (two decodes: two K1 launches
    a sample, or two plain decodes of the batch, :func:`decode_points`) and
    the sampler over its active cells; ``hier=False`` decodes the dense
    ``(vox_res + 1)^3`` grid (one decode) and samples it with the dense
    sampler. ``batch`` holds NHWC ``rgb_input_map [B, H, W, 3]`` and
    ``mask_input_map [B, H, W, 1]`` (numpy or tensors).

    Returns ``(out, level [B, S, S, S], world [B, num_points, 3],
    n_active [B] or None)``: ``out`` is ``encode_image``'s dict, ``n_active``
    the hierarchical decode's active-cell demand.
    """
    graph, dev = model.graph, model.device
    inputs = _inputs(batch, dev)
    B = inputs["rgb_input_map"].shape[0]
    # the spans name the stages in a torch.profiler trace (profile_recon.py)
    with record_function("encode_image"):
        out = graph.encode_image(inputs)
    with record_function("latent_trunk"):
        caches = graph.encode_latents(out)

    def decode_fn(pts):  # [B, T, 3] -> [B, T]
        return model.sharpen * decode_points(model, caches, pts)

    S = vox_res + 1
    with record_function("grid_decode"):
        if hier:
            # each pass is one decode call: the kernel takes any number of points
            tile = resolve_hier_capacity(vox_res, capacity, FACTOR) * (FACTOR + 1) ** 3
            level, n_active, ids, valid = occupancy_grid_hierarchical(
                decode_fn, vox_res, rng, batch_size=B, factor=FACTOR, capacity=capacity, margin=MARGIN,
                tile_points=tile, return_stats=True, return_cells=True, device=dev,
            )
        else:
            grid = get_dense_3D_grid(vox_res, rng, device=dev)
            level = occupancy_grid(decode_fn, grid, B, tile_points=grid.shape[0]).reshape(B, S, S, S)
            n_active = None
    gens = generator if isinstance(generator, (list, tuple)) else [generator] * B
    with record_function("surface_sample"):
        if hier:
            pts = [sample_surface_points_cells(level[b], ids[b], valid[b], gens[b], num_points, factor=FACTOR)
                   for b in range(B)]
        else:
            pts = [sample_surface_points(level[b], gens[b], num_points) for b in range(B)]
        world = torch.stack(pts) / S * (rng[1] - rng[0]) + rng[0]
    return out, level, world, n_active


def reconstruct(
    model,
    batch,
    generator=None,
    vox_res=VOX_RES,
    capacity=CAPACITY,
    num_points=NUM_POINTS,
    rng=RANGE,
    return_level=False,
    hier=True,
):
    """One image -> (world points [P, 3], depth_pred [1, H, W, 1], intr_pred [1, 3, 3], n_active [1]).

    ``batch`` holds NHWC ``rgb_input_map [1, H, W, 3]`` and
    ``mask_input_map [1, H, W, 1]`` (numpy or tensors). With
    ``return_level`` the level grid ``[1, S, S, S]`` comes last. ``hier``
    picks the decode posture of :func:`reconstruct_batch`; the dense one
    reports no ``n_active`` (None).
    """
    if batch["rgb_input_map"].shape[0] != 1:
        raise ValueError("reconstruct takes one image at a time")
    out, level, world, n_active = reconstruct_batch(
        model, batch, generator, vox_res, capacity, num_points, rng, hier
    )
    result = (world[0], out["depth_pred"], out["intr_pred"], n_active)
    return result + (level,) if return_level else result


MODEL_KEYS = ("rgb_input_map", "mask_input_map", "depth_input_map", "intr", "pose_gt", "gt_sample_points",
              "gt_sample_sdf")
# x-slices of the dense grid a decode of the attention pass: 8 x 129^2 points
# hold ~2.5 GiB at full width in bf16 (chip_smoke.py phase 24)
ATTN_SLICES = 8


@torch.inference_mode()
def reconstruct_with_attn(model, batch, generator=None, vox_res=VOX_RES, num_points=NUM_POINTS, rng=RANGE):
    """The dense reconstruction that also returns z-averaged attention maps
    (``Runner._recon_attn_fn``, ``shape_engine.py:373-418``): the graph's
    forward (with its supervision outputs where ``batch`` has the SDF
    samples), the latent trunk, the dense ``(vox_res + 1)^3`` decode through
    the plain ``Implicit.decode`` in the compute dtype, :data:`ATTN_SLICES`
    x-slices of ``(vox_res + 1)^2`` points a call
    (:func:`eval3d.occupancy_grid_with_attn`; the JAX engine decodes one a
    call: the result is the same), the dense sampler.

    ``batch`` holds NHWC ``rgb_input_map``, ``mask_input_map`` and any other
    model keys (numpy or tensors). ``generator`` is one generator or one a
    sample. Returns ``(out, level [B, S, S, S], world [B, num_points, 3],
    attn_xy [B, S, S, L])``.
    """
    graph, dev = model.graph, model.device
    inputs = {k: torch.as_tensor(np.asarray(batch[k]) if not isinstance(batch[k], torch.Tensor) else batch[k],
                                 dtype=torch.float32, device=dev) for k in MODEL_KEYS if k in batch}
    B = inputs["rgb_input_map"].shape[0]
    out = graph(inputs, train=False)
    caches = graph.encode_latents(out)

    def decode_fn(pts):
        logits, attn = graph.impl_network.decode(caches, pts)
        return model.sharpen * logits, attn

    S = vox_res + 1
    occ, attn_xy = occupancy_grid_with_attn(decode_fn, get_dense_3D_grid(vox_res, rng, device=dev), B, vox_res,
                                            ATTN_SLICES)
    level = occ.reshape(B, S, S, S)
    gens = generator if isinstance(generator, (list, tuple)) else [generator] * B
    pts = torch.stack([sample_surface_points(level[b], gens[b], num_points) for b in range(B)])
    return out, level, pts / S * (rng[1] - rng[0]) + rng[0], attn_xy
