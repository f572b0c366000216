"""PyTorch port, inverse rendering: partition/combine, the masked optimizer,
checkpoints, recovery of perturbed parameters by gradient descent through
the chain adjoint (its plain version on the CPU), and JAX state carried
across."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingengine_tpu.inverse import combine as jax_combine
from raytracingengine_tpu.inverse import partition as jax_partition
from raytracingengine_tpu.inverse.loss import l1_image_loss as jax_l1
from raytracingengine_tpu.inverse.loss import l2_image_loss as jax_l2
from raytracingengine_tpu.render.config import RenderConfig as JaxConfig
from raytracingengine_tpu.render.pipeline import render_hdr as jax_render_hdr
from raytracingengine_tpu.scenes import builders as jax_builders
from raytracingengine_tpu_torch.convert import params_from_numpy, scene_to_numpy
from raytracingengine_tpu_torch.inverse import (
    combine,
    fit,
    l1_image_loss,
    l2_image_loss,
    make_train_step,
    masked_optimizer,
    partition,
    select,
)
from raytracingengine_tpu_torch.inverse.checkpoint import restore_checkpoint, save_checkpoint
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.pipeline import render_hdr
from raytracingengine_tpu_torch.scenes import builders
from jax_refs import jit_o0

torch.set_num_threads(2)

CFG = RenderConfig(shadow_mode="binary", use_pallas=True)


def spheres(size=8, **kw):
    return builders.baseline_sphere_scene(width=size, height=size, spp=1, device="cpu", **kw)


def test_partition_combine_roundtrip():
    scene, _ = spheres()
    params, static = partition(scene)
    back = combine(params, static)
    ours, ref = scene_to_numpy(back), scene_to_numpy(scene)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert params and all(p.is_floating_point() and p.requires_grad for p in params.values())
    assert sorted(params) == sorted(k for k, v in ref.items() if np.issubdtype(v.dtype, np.floating))
    # the static half holds no float leaf
    assert all(not np.issubdtype(v.dtype, np.floating) for v in scene_to_numpy(static).values())


def test_masked_leaf_never_moves():
    """Frozen leaves stay bit-identical, even under an optimizer whose
    update moves a parameter with a zero gradient (weight decay)."""
    scene, cam = spheres()
    with torch.no_grad():
        target = render_hdr(scene, cam, CFG) * 0.5
    params0, _ = partition(scene)
    mask = select(params0, ["lights.intensities"])
    make = lambda ps: torch.optim.AdamW(ps.values(), lr=0.5, weight_decay=0.5)  # noqa: E731
    fitted, losses = fit(scene, cam, CFG, target, steps=3, optimizer=make, mask=mask)
    before, after = scene_to_numpy(scene), scene_to_numpy(fitted)
    for k, keep in mask.items():
        if keep:
            assert not np.array_equal(after[k], before[k]), k
        else:
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert losses[-1] < losses[0]


def test_train_step_returns_grads_and_updates():
    scene, cam = spheres()
    params, static = partition(scene)
    opt = masked_optimizer(params, None, lambda ps: torch.optim.SGD(ps.values(), lr=1e-6))
    step = make_train_step(cam, CFG, opt, loss_fn=lambda img, t: (img * img).mean())
    start = {k: p.detach().clone() for k, p in params.items()}
    loss, grads = step(params, static, None)
    assert torch.isfinite(loss) and sorted(grads) == sorted(params)
    moved = [k for k, p in params.items() if not torch.equal(p.detach(), start[k])]
    assert "spheres.centers" in moved and "lights.positions" in moved


def test_checkpoint_roundtrip(tmp_path):
    scene, cam = spheres()
    params, static = partition(scene)
    opt = torch.optim.Adam(params.values(), lr=1e-2)
    step = make_train_step(cam, CFG, opt, loss_fn=lambda img, t: (img * img).mean())
    step(params, static, None)
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, params, opt.state_dict(), step=17)
    restored = restore_checkpoint(path, device="cpu")
    assert restored["step"] == 17
    for k, p in params.items():
        np.testing.assert_array_equal(restored["params"][k].numpy(), p.detach().numpy())
    params2 = {k: v.clone().requires_grad_(True) for k, v in restored["params"].items()}
    opt2 = torch.optim.Adam(params2.values(), lr=1e-2)
    opt2.load_state_dict(restored["opt_state"])
    for s1, s2 in zip(opt.state.values(), opt2.state.values()):
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(s1[key].numpy(), s2[key].numpy())


def _perturb(scene, d_albedo=0.15, d_intensity=12.0):
    sph = scene.spheres
    mats = dataclasses.replace(sph.materials, color=torch.clamp(sph.materials.color + d_albedo, 0.0, 1.0))
    lights = dataclasses.replace(scene.lights, intensities=scene.lights.intensities + d_intensity)
    return dataclasses.replace(scene, spheres=dataclasses.replace(sph, materials=mats), lights=lights)


def test_recover_albedo_and_intensity():
    """tests/test_inverse.py's bar: 120 Adam steps (lr 2e-2 albedo, 0.5
    intensity) cut the loss below 5% and halve the intensity error. One
    whole-frame chunk, so each step is one call of the plain adjoint."""
    scene_true, cam = spheres(size=24)
    cfg = dataclasses.replace(CFG, chunk_size=24 * 24)
    with torch.no_grad():
        target = render_hdr(scene_true, cam, cfg)
    scene0 = _perturb(scene_true)
    params0, _ = partition(scene0)
    mask = select(params0, ["spheres.materials.color", "lights.intensities"])
    make = lambda ps: torch.optim.Adam([  # noqa: E731
        {"params": [ps["spheres.materials.color"]], "lr": 2e-2},
        {"params": [ps["lights.intensities"]], "lr": 0.5},
    ])
    fitted, losses = fit(scene0, cam, cfg, target, steps=120, optimizer=make, mask=mask)
    assert losses[-1] < losses[0] * 0.05, f"{losses[0]} -> {losses[-1]}"
    true_i = float(scene_true.lights.intensities[0])
    fit_i = float(fitted.lights.intensities[0])
    assert abs(fit_i - true_i) < abs(12.0) * 0.5


@pytest.mark.parametrize("fn", ["l1", "l2"])
def test_losses_match_jax(fn):
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(2, 6, 5, 3)).astype(np.float32)
    ours = {"l1": l1_image_loss, "l2": l2_image_loss}[fn](torch.from_numpy(a), torch.from_numpy(b))
    ref = {"l1": jax_l1, "l2": jax_l2}[fn](jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


def test_jax_params_carry_across():
    """JAX `partition` leaves -> params_from_numpy -> the port's combine:
    the same loss as JAX on the same scene, rtol 1e-5."""
    j_scene, j_cam = jax_builders.baseline_sphere_scene(width=16, height=16, spp=1, n_lights=2)
    j_params, j_static = jax_partition(j_scene)
    j_params = jax.tree.map(lambda x: x * 1.01, j_params)  # not the builder's values
    flat, _ = jax.tree_util.tree_flatten_with_path(j_params)
    leaves = {".".join(k.name for k in path): np.asarray(x) for path, x in flat}
    jcfg = JaxConfig(shadow_mode="binary", chunk_size=256)
    ref = float(jit_o0(lambda p: jnp.mean(jax_render_hdr(jax_combine(p, j_static), j_cam, jcfg) ** 2))(
        j_params))

    scene, cam = builders.baseline_sphere_scene(width=16, height=16, spp=1, n_lights=2, device="cpu")
    params = params_from_numpy(leaves, device="cpu")
    _, static = partition(scene)
    assert sorted(params) == sorted(partition(scene)[0])
    assert all(p.requires_grad for p in params.values())
    img = render_hdr(combine(params, static), cam, CFG)
    np.testing.assert_allclose(float((img * img).mean().detach()), ref, rtol=1e-5)
