"""The port's train CLI with the non-default encoders, at tiny size on the CPU.

``python -m zeroshape_tpu_torch.train --arch.depth.encoder=transformer
--arch.depth.dsp=2 --arch.rgb.encoder=resnet --arch.impl.posenc_3D=2`` (the
dotted overrides of the JAX CLI) on an analytic tree at 32^2: one step with the DPT frozen,
validation before it and after it (the plain decode: the tiny decoder is
not K1's), and a ``best.ckpt`` that the port loads back into the graph the
same options build, key for key.
"""

import numpy as np
import torch

from zeroshape_tpu_torch.data import analytic
from zeroshape_tpu_torch.models.coord_enc import CoordEncAtt
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
from zeroshape_tpu_torch.models.rgb_enc import RGBEncRes
from zeroshape_tpu_torch.runtime import checkpoint
from zeroshape_tpu_torch.train import main as train_main
from zeroshape_tpu_torch.train import options as train_options

from test_torch_harness import few_threads, give_memory_back  # noqa: F401 (autouse fixtures)

H = 32
VARIANT = ["--arch.depth.encoder=transformer", "--arch.depth.n_blocks=2", "--arch.depth.dsp=2",
           "--arch.rgb.encoder=resnet", "--arch.impl.posenc_3D=2"]
TINY = [f"--image_size=[{H},{H}]", "--arch.latent_dim=64", "--arch.impl.n_channels=64", "--arch.impl.mlp_layers=4",
        "--arch.impl.skip_in=[2]", "--batch_size=4", "--max_epoch=1", "--seed=3", "--training.n_sdf_points=64",
        "--optim.fix_dpt", "--tb=null", "--freq.print=1", "--freq.scalar=1", "--freq.eval=1", "--eval.vox_res=16",
        "--eval.num_points=200", "--eval.n_vis=0", "--device=cpu"]


def test_train_cli_takes_the_encoder_options(tmp_path):
    analytic.generate_dataset(str(tmp_path / "data"), n_objects=2, n_views=3, H=H, seed=0, n_pc_points=300,
                              n_sdf_points=400)
    argv = VARIANT + TINY + [f"--data.root={tmp_path / 'data'}", f"--output_path={tmp_path / 'run'}"]
    opt = train_options(argv)
    assert (opt.arch.depth.encoder, opt.arch.rgb.encoder, opt.arch.impl.posenc_3D) == ("transformer", "resnet", 2)
    res = train_main(argv)
    graph = res["graph"]
    assert isinstance(graph.coord_encoder, CoordEncAtt) and isinstance(graph.rgb_encoder, RGBEncRes)
    assert graph.depth_dsp == 2 and graph.impl_network.semantic and graph.impl_network.impl_mlp.posenc_res == 2
    assert res["it"] == 1 and len(res["losses"]) == 1 and np.isfinite(res["losses"]).all()
    assert [ep for ep, _ in res["val"]] == [0, 1] and np.isfinite([cd for _, cd in res["val"]]).all()
    fresh = ShapeGraph.from_opt(opt)
    checkpoint.apply_weights(fresh, checkpoint.load_reference_ckpt(str(tmp_path / "run" / "best.ckpt")), strict=True)
    want = graph.state_dict()
    assert all(torch.equal(x, want[k].cpu()) for k, x in fresh.state_dict().items())
