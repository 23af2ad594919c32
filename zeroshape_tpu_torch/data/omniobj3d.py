"""The OmniObject3D evaluation set (counterpart of ``zeroshape_tpu/data/omniobj3d.py``):
OCRTOC's layout without the subsample, with ``depth/`` for ``depth_np/``
and no eroded mask."""

from __future__ import annotations

from zeroshape_tpu_torch.data.ocrtoc import OcrtocDataset


class OmniObject3DDataset(OcrtocDataset):
    dataset_dir = "OmniObject3D"
    subsample_every = 1
    has_erode = False
    depth_dirname = "depth"


Dataset = OmniObject3DDataset
