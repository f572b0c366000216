"""Sharded rendering and training over a mesh (parallel/mesh.py).

The reference's OpenMP pixel loop (Scene.h:318-320) becomes ranks:

  * `render_hdr_sharded`: each ray shard renders a contiguous run of the
    frame's row-major pixels through the one-process chunk path
    (render/pipeline.py::render_pixels, the kernels included), and the ray
    group all_gathers the frame onto every rank. A pixel's jitter is keyed
    by its row-major id, so the frame is the one-process frame at every spp
    and shard count. With a prim axis each rank keeps its contiguous block
    of the triangles (`shard_triangles`), the integrators combine the
    ranks' hits (geometry/intersect.py::closest_hit), and use_pallas gives
    way to them with a warning: the kernels keep whole tables. Forward only.
  * `render_hdr_auto`, which `render_hdr(..., mesh=)` calls: the pixels
    split over every rank of the mesh and the frame gathered, both
    differentiably: the gather's backward hands each rank the cotangent of
    its own pixels, and the scene's and camera's tensors that require grad
    enter through `replicated`, whose backward sums their gradients over
    the ranks. Every rank computes the same loss from the gathered frame
    and calls backward; each then holds the one-process gradient.
    (torch.distributed.nn.functional's all_gather would hand each rank the
    sum of every rank's cotangent, a world-size factor on a replicated
    loss, and its backward is a reduce_scatter, which gloo lacks.)
  * `make_sharded_loss`: the training loss through the fused kernels
    (pipeline._trace: chain_trace_fused, wavefront_trace_fused), the rays
    split over the ray group, the squared-error sum all_reduced and the
    replicated parameters' gradients all_reduced in the backward.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from raytracingengine_tpu_torch.core.camera import Camera
from raytracingengine_tpu_torch.geometry.intersect import flatten_scene, gather_over
from raytracingengine_tpu_torch.inverse.params import _replace, combine
from raytracingengine_tpu_torch.parallel.mesh import Mesh
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.pipeline import _tables, _trace, render_pixels
from raytracingengine_tpu_torch.scene import Scene, tensor_leaves


def shard_triangles(scene: Scene, index: int, n: int) -> Scene:
    """The scene with only block `index` of `n` contiguous blocks of its
    triangles (every per-triangle tensor cut along its first axis); the
    triangle count must divide by n (build the scene with pad_multiple)."""
    tri = scene.triangles
    t = len(tri)
    if t % n:
        raise ValueError(f"{t} triangles do not split into {n} prim shards: build the scene "
                         f"with pad_multiple={n}")
    lo, hi = index * t // n, (index + 1) * t // n
    blocks = {k: v[lo:hi] for k, v in tensor_leaves(tri).items() if v is not None}
    return dataclasses.replace(scene, triangles=_replace(tri, blocks))


class _Replicated(torch.autograd.Function):
    """Identity forward; the backward sums each gradient over `group`."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        grads = [g.contiguous() for g in grads]
        for g in grads:
            dist.all_reduce(g, group=ctx.group)
        return (None, *grads)


def replicated(obj, group):
    """A dataclass tree (a Scene, a Camera) or a dict of tensors, replicated
    on every rank of `group` -> the same, whose tensors that require grad
    pass through `_Replicated`: a loss that reaches them on several ranks
    gets their gradients summed over the group on every rank."""
    leaves = obj if isinstance(obj, dict) else tensor_leaves(obj)
    names = [k for k, v in leaves.items() if v is not None and v.requires_grad]
    if not names or not torch.is_grad_enabled():
        return obj
    out = dict(zip(names, _Replicated.apply(group, *(leaves[k] for k in names))))
    return {**obj, **out} if isinstance(obj, dict) else _replace(obj, out)


class _GatherRows(torch.autograd.Function):
    """[rows, ...] on each rank of `group` -> [ranks * rows, ...] in rank
    order; the backward hands each rank the cotangent of its own rows (a
    loss every rank computes alike)."""

    @staticmethod
    def forward(ctx, part, group):
        ctx.group, ctx.rows = group, part.shape[0]
        return gather_over(part, group).flatten(0, 1)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g[i * ctx.rows:(i + 1) * ctx.rows], None


def _shard(r: int, n: int, i: int) -> tuple[int, int, int]:
    """Pixels 0 .. r-1 over n shards -> (first, end, rows per shard) of
    shard i: runs of ceil(r / n), the last ones short or empty."""
    rows = -(-r // n)
    lo = min(i * rows, r)
    return lo, min(lo + rows, r), rows


def _render_shard(scene, camera, cfg, lo, hi, rows, seed, prim_group=None) -> torch.Tensor:
    """Pixels lo .. hi - 1, padded with zeros to `rows` for the gather."""
    part = render_pixels(scene, camera, cfg, lo, hi, seed=seed, prim_group=prim_group) if hi > lo \
        else torch.zeros((0, 3), device=scene.device)
    return torch.nn.functional.pad(part, (0, 0, 0, rows - part.shape[0]))


def render_hdr_sharded(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: Mesh,
                       seed: int = 0) -> torch.Tensor:
    """The full frame on every rank -> [H, W, 3], forward only: this rank
    renders its ray shard's pixels (with its prim shard's triangles where
    the mesh has a prim axis) and the ray group gathers them. With one ray
    shard in a world, the gather still runs (over a group of one)."""
    r = camera.num_pixels
    lo, hi, rows = _shard(r, mesh.n_ray, mesh.ray_index)
    prim_group = None
    if mesh.n_prim > 1:
        scene, prim_group = shard_triangles(scene, mesh.prim_index, mesh.n_prim), mesh.prim_group
    with torch.no_grad():
        part = _render_shard(scene, camera, cfg, lo, hi, rows, seed, prim_group)
        frame = part if mesh.ray_group is None else gather_over(part, mesh.ray_group).flatten(0, 1)
    return frame[:r].reshape(camera.height, camera.width, 3)


def render_hdr_auto(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: Mesh,
                    seed: int = 0) -> torch.Tensor:
    """`render_hdr(..., mesh=mesh)`: the pixels split over every rank of the
    mesh, the frame gathered onto each, differentiable in the scene's and
    the camera's tensors (the module docstring says how)."""
    r = camera.num_pixels
    if not dist.is_initialized():
        img = render_pixels(scene, camera, cfg, 0, r, seed=seed)
        return img.reshape(camera.height, camera.width, 3)
    lo, hi, rows = _shard(r, mesh.size, mesh.rank)
    scene, camera = replicated(scene, None), replicated(camera, None)
    part = _render_shard(scene, camera, cfg, lo, hi, rows, seed)
    return _GatherRows.apply(part, None)[:r].reshape(camera.height, camera.width, 3)


def make_sharded_loss(static, cfg: RenderConfig, mesh: Mesh, mode: str = "chain"):
    """-> loss(params, o, d, target): the mean squared error of the render
    of combine(params, static) at the rays o, d [R,3] against target [R,3],
    with R divisible by the mesh's ray shards. This rank traces its
    contiguous R / n_ray rays through the fused kernels where
    `cfg.use_pallas` applies (else the integrators); the squared-error sums
    are all_reduced over the ray group, and so are the params' gradients in
    the backward, so every rank gets the one-process loss and gradients."""

    def loss(params: dict[str, torch.Tensor], o: torch.Tensor, d: torch.Tensor,
             target: torch.Tensor) -> torch.Tensor:
        n, i, r = mesh.n_ray, mesh.ray_index, o.shape[0]
        if r % n:
            raise ValueError(f"{r} rays do not split into {n} ray shards")
        lo, hi = i * r // n, (i + 1) * r // n
        group = mesh.ray_group
        if group is not None:
            params = replicated(params, group)
        flat = flatten_scene(combine(params, static))
        oo, dd = o[lo:hi].contiguous(), d[lo:hi].contiguous()
        img = _trace(flat, _tables(flat, mode, cfg, dd), mode, oo, dd, cfg)
        local = ((img - target[lo:hi]) ** 2).sum()
        total = local.detach().clone()
        if group is not None:
            dist.all_reduce(total, group=group)
        return (local - local.detach() + total) / target.numel()

    return loss
