"""The overfit tree and ``measure_hier``'s count against the JAX package:
``python -m zeroshape_tpu_torch.overfit_e2e gen`` at ``--H=32
--n_objects=2`` against JAX ``data.analytic.generate_dataset`` with
``scripts/overfit_e2e.py``'s arguments at those overrides (the same files;
arrays equal, PNG pixels equal), and ``measure_hier.measure``'s ``n_active``
on a tiny graph whose weights come from JAX variables through
``weights.from_flax`` against JAX ``occupancy_grid_hierarchical
(return_stats=True)`` of the JAX decoder with the same weights on the same
latent tokens: equal counts.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _batch
from zeroshape_tpu.data.analytic import generate_dataset as jax_generate
from zeroshape_tpu.metrics import eval3d as je
from zeroshape_tpu.models.graph_shape import ShapeGraph as JShapeGraph
from zeroshape_tpu_torch import config, measure_hier, overfit_e2e, recon, weights
from zeroshape_tpu_torch.data.native import decode_png
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph

from test_torch_harness import few_threads, give_memory_back, random_variables  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_overfit_gen_writes_the_jax_scripts_tree(tmp_path):
    script = open(os.path.join(REPO, "scripts", "overfit_e2e.py")).read()
    assert ("root, n_objects=5, n_views=8, H=224, seed=0,\n        n_pc_points=10000, n_sdf_points=20000, "
            "val_views=1,") in script and '"/tmp/overfit_data"' in script
    assert overfit_e2e.ROOT == "/tmp/overfit_data"
    port, jax_root = tmp_path / "port", tmp_path / "jax"
    overfit_e2e.main(["gen", str(port), "--H=32", "--n_objects=2"])
    jax_generate(str(jax_root), n_objects=2, n_views=8, H=32, seed=0, n_pc_points=10000, n_sdf_points=20000,
                 val_views=1)
    files = _files(port)
    assert files == _files(jax_root) and len(files) > 40
    for rel in files:
        a, b = str(port / rel), str(jax_root / rel)
        if rel.endswith(".npy"):
            x, y = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
            if x.dtype == object:
                x, y = x.item(), y.item()
                assert sorted(x) == sorted(y), rel
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=f"{rel}:{k}")
            else:
                np.testing.assert_array_equal(x, y, err_msg=rel)
        elif rel.endswith(".png"):
            np.testing.assert_array_equal(decode_png(a), decode_png(b), err_msg=rel)
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), rel


H, VOX, CAP = 32, 32, 64


@pytest.fixture(scope="module")
def graphs():
    """A tiny graph (full-width encoders) with JAX random variables in both
    packages; the decoder's output layer then set by
    ``recon.calibrate_random_field`` on the first image (its zero level at a
    tenth of the coarse lattice, steep enough for about 100 active cells)
    and copied back to the JAX variables, so that the field has confident
    cells and a surface."""
    opt = config.tiny_opt(H)
    jmodel = JShapeGraph.from_opt(opt)
    v = random_variables(jmodel, _batch(B=1, H=H, n_pts=8), train=False, seed=3)
    head = v["params"]["dpt_depth"]["head_conv3"]  # keep the depth head in its clamp (tests/test_torch_parity.py)
    head["kernel"] = head["kernel"] * 1e-2
    head["bias"] = np.full_like(head["bias"], 0.5)
    port = ShapeGraph.from_opt(opt)
    weights.load(port, weights.from_flax(v["params"], v["batch_stats"], impl_blocks=2, impl_mlp_linears=5))
    images = [config.synthetic_image(H, seed=s) for s in (4, 5)]
    model = recon.ReconModel(port.eval(), None, 1.0, torch.device("cpu"))
    rgb, mask = images[0]
    recon.calibrate_random_field(model, {"rgb_input_map": rgb, "mask_input_map": mask}, target=100, vox_res=VOX)
    out, layer = v["params"]["impl_network"]["impl_mlp"]["lin4"], port.impl_network.output_layer
    out["kernel"], out["bias"] = layer.weight.detach().numpy().T.copy(), layer.bias.detach().numpy().copy()
    return jmodel, v, model, images


def test_measure_hier_counts_the_jax_hierarchical_decode(graphs, capsys):
    jmodel, v, model, images = graphs
    samples = [{"rgb_input_map": rgb[0], "mask_input_map": mask[0], "idx": i} for i, (rgb, mask) in enumerate(images)]
    opt = config.eval_opt(config.tiny_opt(H), vox_res=VOX, hier_capacity=CAP, num_points=200, batch_size=2)
    opt.data.num_workers = 0
    got = measure_hier.measure(model, samples, opt, "tiny")
    # the JAX decoder on the port's latent tokens (the graphs' encoders agree:
    # tests/test_torch_port_graph.py), so only the decode and its count differ
    with torch.inference_mode():
        inputs = {k: torch.as_tensor(np.concatenate([im[i] for im in images])) for i, k in
                  enumerate(("rgb_input_map", "mask_input_map"))}
        latent = jnp.asarray(model.graph.encode_image(inputs)["latent_depth"].numpy())
    caches = jmodel.apply(v, latent, method=lambda m, lat: m.impl_network.encode(lat))
    decode = jax.jit(lambda pts: jmodel.apply(v, caches, pts, method=lambda m, c, p: m.impl_network.decode(c, p)[0]))
    _, n_active = je.occupancy_grid_hierarchical(decode, VOX, batch_size=2, capacity=CAP, return_stats=True)
    want = np.asarray(n_active).tolist()
    assert got.tolist() == want and 0 < min(want) and max(want) < (VOX // 4) ** 3, (got, want)
    assert capsys.readouterr().out.splitlines() == [f"[tiny] batch 0: n_active {want}"]
    opt.eval.hier_capacity = (VOX // 4) ** 3  # the dense decode is cheaper: no count to measure
    with pytest.raises(RuntimeError, match="dense decode has no active-cell count"):
        measure_hier.measure(model, samples, opt, "tiny")
