"""PyTorch port vs the JAX package: the sample axis and the camera's pose helpers.

Where the JAX package handles a batch of samples in one call, so does the
port: K1 over a batch (``fused_decode_batched``, its plain version here,
against the JAX kernel's ``vmap`` in interpret mode), the batched cache
packing, the batched brute force (``brute_force_batch`` against
``make_brute_force_batch``) and the batched coarse-to-fine cell selection
(``occupancy_grid_hierarchical`` at B = 3). Each batched call also equals
the port's own one-sample-at-a-time loop bit for bit. The pose helpers are
held to ``zeroshape_tpu/camera.py``'s. Inputs come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshape_tpu import camera as jcam
from zeroshape_tpu.metrics import eval3d as je
from zeroshape_tpu.models.implicit import Implicit as JImplicit
from zeroshape_tpu.ops.implicit_kernel import fused_decode_batched as j_fused_decode_batched
from zeroshape_tpu.ops.implicit_kernel import pack_decoder_params as j_pack
from zeroshape_tpu_torch import camera as tcam
from zeroshape_tpu_torch import weights as W
from zeroshape_tpu_torch.data import analytic
from zeroshape_tpu_torch.metrics import eval3d as te
from zeroshape_tpu_torch.models.implicit import Implicit
from zeroshape_tpu_torch.ops import implicit_kernel as ik

from test_torch_harness import close, np32, t
from test_torch_harness import few_threads, give_memory_back  # noqa: F401 (autouse fixtures)

B = 3
ROT = (4, 4, 2)  # 32 rotations: small enough for the CPU, with a clear winner a sample


@pytest.fixture(scope="module")
def small():
    """The small decoder of tests/test_implicit_kernel.py:13-29 in both
    packages (the port's weights converted from the flax ones), B = 3
    samples' latents and 200 points a sample."""
    m = JImplicit(num_patches=16, latent_dim=32, n_channels=64, n_blocks_attn=2, n_layers_mlp=4,
                  num_heads=4, skip_in=(2,), drop_path=0.1)
    rng = np.random.default_rng(1)
    latent = rng.normal(size=(B, 17, 32)).astype(np.float32)
    points = rng.normal(size=(B, 200, 3)).astype(np.float32)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(latent[:1]), None, jnp.asarray(points[:1]))
    params = jax.tree.map(np.asarray, v["params"])
    port = Implicit(num_patches=16, latent_dim=32, n_channels=64, n_blocks_attn=2, n_layers_mlp=4,
                    num_heads=4, skip_in=(2,))
    W.load(port, W.convert(W.map_implicit("", (), 2, 5), params))
    return m, v, port.eval(), latent, points


def test_fused_decode_batched_matches_jax_and_the_per_sample_loop(small):
    m, v, port, latent, points = small
    caches = m.apply(v, jnp.asarray(latent), method=lambda md, l: md.encode(l))
    want = j_fused_decode_batched(
        jnp.asarray(points), caches, j_pack(v["params"], n_blocks=2, n_mlp_linears=5),
        latent_len=17, n_blocks=2, n_heads=4, skip_in=(2,), n_mlp_linears=5, tile=128, interpret=True,
    )
    with torch.no_grad():
        tc = port.encode(t(latent))
        got = ik.fused_decode_batched(port, tc, t(points))
        loop = torch.stack([ik.fused_decode(port, [(k[b : b + 1], vv[b : b + 1]) for k, vv in tc], t(points[b]))
                            for b in range(B)])
    assert tuple(got.shape) == (B, 200)
    assert torch.equal(got, loop)
    a, b = np32(got).ravel(), np32(want).ravel()
    np.testing.assert_allclose(a, b, rtol=8e-2, atol=2e-2)  # the kernel's bf16 bounds
    assert np.corrcoef(a, b)[0, 1] > 0.9999


def test_fused_decode_batched_rejects_unbatched_points(small):
    _, _, port, latent, points = small
    with torch.no_grad(), pytest.raises(ValueError, match=r"\[B, P, 3\]"):
        ik.fused_decode_batched(port, port.encode(t(latent)), t(points[0]))


@pytest.mark.parametrize("L", [197, ik.MAX_LATENT])
def test_batched_cache_packing_is_single_packs_concatenated(L):
    g = torch.Generator().manual_seed(L)
    caches = [tuple(torch.randn(B, 8, L, 32, generator=g) for _ in range(2)) for _ in range(2)]
    flat, n = ik.pack_caches(caches)
    assert n == L and tuple(flat.shape) == (B, ik.CACHE_ELEMS) and flat.dtype == torch.bfloat16
    singles = [ik.pack_caches([(k[b : b + 1], v[b : b + 1]) for k, v in caches])[0] for b in range(B)]
    assert torch.equal(flat, torch.cat(singles))
    k, v = ik.unpack_caches(flat, L)
    for blk, (kk, vv) in enumerate(caches):
        assert torch.equal(k[:, blk], kk.to(torch.bfloat16))
        assert torch.equal(v[:, blk], vv.to(torch.bfloat16))


@pytest.fixture(scope="module")
def cloud_batch():
    """B analytic cloud pairs, each its own shape: a GT cloud and an
    independent draw of it turned by the inverse of a sphere rotation."""
    rng = np.random.default_rng(7)
    R = np.asarray(jcam.get_rotation_sphere(*ROT))
    preds, gts = [], []
    for b, kind in enumerate(("box", "torus", "capsule")):
        sdf, _ = analytic.make_sdf(kind, rng)
        gts.append(analytic.surface_points(sdf, 320, rng))
        preds.append(analytic.surface_points(sdf, 300, rng) @ R[5 + 9 * b])
    return np.stack(preds).astype(np.float32), np.stack(gts).astype(np.float32)


@pytest.mark.parametrize("prune", [None, (64, 8)])
def test_brute_force_batch_matches_jax_and_the_per_sample_search(cloud_batch, prune):
    pred, gt = cloud_batch
    got = te.brute_force_batch(t(pred), t(gt), rot_samples=ROT, prune=prune)
    want = je.make_brute_force_batch(rot_samples=ROT, prune=prune, use_pallas=False)(jnp.asarray(pred),
                                                                                     jnp.asarray(gt))
    close(got["rotation"], want["rotation"], 1e-6)
    for k in ("acc", "comp", "f_score", "pc_pred", "pc_gt"):
        close(got[k], want[k], 1e-5, k)
    assert tuple(got["f_score"].shape) == (B, 6) and tuple(got["pc_pred"].shape) == pred.shape
    for b in range(B):
        one = te.brute_force_search(t(pred[b]), t(gt[b]), rot_samples=ROT, prune=prune)
        for k, x in one.items():
            assert torch.equal(got[k][b], x), (b, k)


def _spheres(centre, radius, steep=6.0):
    """Logits of one sphere a sample: ``decode_fn`` for points [B, T, 3],
    elementwise (a reduction's order may depend on the batch on the CPU)."""
    c, r = torch.as_tensor(centre), torch.as_tensor(radius)

    def fn(p):
        d = p - c[:, None]
        return steep * (r[:, None] - torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]))

    return fn


def _jspheres(centre, radius, steep=6.0):
    c, r = jnp.asarray(centre), jnp.asarray(radius)

    def fn(p):
        return steep * (r[:, None] - jnp.linalg.norm(p - c[:, None], axis=-1))

    return fn


def test_batched_hierarchical_decode_matches_jax_and_the_per_sample_loop():
    vox, cap, factor = 32, 200, 4  # the large sphere of sample 2 asks for 440 cells, the others for 160 and 95
    centre = np.array([[0.1, -0.2, 0.0], [-0.3, 0.2, 0.1], [0.0, 0.0, 0.05]], np.float32)
    radius = np.array([0.5, 0.3, 1.1], np.float32)
    kw = dict(batch_size=B, capacity=cap, tile_points=(vox + 1) ** 2, return_stats=True, return_cells=True)
    field = _spheres(centre, radius)
    level, n_act, ids, valid = te.occupancy_grid_hierarchical(field, vox, device="cpu", **kw)
    jlevel, jn_act, jids, jvalid = je.occupancy_grid_hierarchical(_jspheres(centre, radius), vox, **kw)
    assert n_act.tolist() == np.asarray(jn_act).tolist()
    assert int(n_act[2]) > cap >= int(n_act[:2].max())
    close(level, jlevel, 1e-6)
    for b in range(B):
        assert set(ids[b][valid[b]].tolist()) == set(np.asarray(jids)[b][np.asarray(jvalid)[b]].tolist())
    # the batch's coarse grids, as the decode makes them; the selection and the
    # fill of the batch equal the parent's loop over its samples bit for bit
    Sc = vox // factor + 1
    occ_c = te.occupancy_grid(field, te.coarse_lattice(vox, device="cpu"), B, (vox + 1) ** 2).reshape(B, Sc, Sc, Sc)
    loop = [te._select_active_cells(o, 0.45, cap) for o in occ_c]
    for got, want in zip((ids, valid, n_act), zip(*loop)):
        assert torch.equal(got, torch.stack(want))
    fill = te._upsample_nearest(occ_c, factor)
    assert torch.equal(fill, torch.stack([te._upsample_nearest(o, factor) for o in occ_c]))


def _poses(rng, n):
    q = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    q = q * np.sign(np.linalg.det(q))[:, None, None]  # proper rotations
    return q.astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32)


def test_pose_helpers_match_jax():
    rng = np.random.default_rng(4)
    (Ra, ta), (Rb, tb), (Rc, tc) = (_poses(rng, 2) for _ in range(3))
    tp = [tcam.pose_from(t(R), t(x)) for R, x in ((Ra, ta), (Rb, tb), (Rc, tc))]
    jp = [jcam.pose_from(jnp.asarray(R), jnp.asarray(x)) for R, x in ((Ra, ta), (Rb, tb), (Rc, tc))]
    close(tp[0], jp[0], 0)
    close(tcam.pose_from(R=t(Ra)), jcam.pose_from(R=jnp.asarray(Ra)), 0)
    close(tcam.pose_from(t=t(ta)), jcam.pose_from(t=jnp.asarray(ta)), 0)
    with pytest.raises(ValueError):
        tcam.pose_from()
    close(tcam.pose_invert(tp[0]), jcam.pose_invert(jp[0]), 1e-6)
    close(tcam.pose_compose_pair(tp[0], tp[1]), jcam.pose_compose_pair(jp[0], jp[1]), 1e-6)
    close(tcam.pose_compose(tp), jcam.pose_compose(jp), 1e-6)
    close(tcam.pose_compose_pair(tp[0], tcam.pose_invert(tp[0])), tcam.pose_from(t=torch.zeros(2, 3)), 1e-6)
    pts = rng.normal(size=(2, 50, 3)).astype(np.float32)
    close(tcam.to_hom(t(pts)), jcam.to_hom(jnp.asarray(pts)), 0)
    close(tcam.world2cam(t(pts), tp[1]), jcam.world2cam(jnp.asarray(pts), jp[1]), 1e-6)
    intr = np.array([[[1.3, 0.0, 0.5], [0.0, 1.3, 0.5], [0.0, 0.0, 1.0]]] * 2, np.float32)
    cam = tcam.pose_from(t(Ra), torch.tensor([[0.0, 0.0, 8.0]] * 2))  # every point in front of the camera
    xy, depth = tcam.proj_points(t(pts), t(intr), cam)
    jxy, jdepth = jcam.proj_points(jnp.asarray(pts), jnp.asarray(intr), jcam.pose_from(
        jnp.asarray(Ra), jnp.asarray([[0.0, 0.0, 8.0]] * 2)))
    assert float(depth.min()) > 0
    close(xy, jxy, 1e-6)
    close(depth, jdepth, 1e-6)
