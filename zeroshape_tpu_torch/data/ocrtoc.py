"""The OCRTOC evaluation set (counterpart of ``zeroshape_tpu/data/ocrtoc.py``):
every 5th image of each list, depth from ``depth_np/``, fixed intrinsics,
and the eroded mask ``mask_eroded`` where ``data.ocrtoc.erode_mask`` is set.
"""

from __future__ import annotations

import os

import numpy as np

from zeroshape_tpu_torch.data import base, common


class OcrtocDataset(base.Dataset):
    dataset_dir = "Ocrtoc"
    subsample_every = 5
    has_erode = True
    depth_dirname = "depth_np"

    def __init__(self, opt, split="test", load_3D=True):
        super().__init__(opt, split)
        self.path = os.path.join(opt.data.get("root", "data"), self.dataset_dir)
        self.load_3D = load_3D
        self.cat_names = [name[:-10] for name in sorted(os.listdir(os.path.join(self.path, "lists")))
                          if name.endswith("_test.list")]
        self.cat2label = {c: i for i, c in enumerate(self.cat_names)}
        self.label2cat = self.cat_names
        if split != "test":
            raise ValueError(f"{type(self).__name__} only has a test split, got {split!r}")
        self.list = self.get_list(opt, split)

    def get_list(self, opt, split):
        cads = []
        for c in self.cat_names:
            with open(os.path.join(self.path, "lists", f"{c}_{split}.list")) as f:
                for i, image_name in enumerate(f.read().splitlines()):
                    if i % self.subsample_every == 0:
                        cads.append((c, image_name.split(".")[0]))
        return cads

    def id_filename_mapping(self, opt, outpath):
        # the point-cloud column names the view, as the reference writes it
        # (data/ocrtoc.py:51), though clouds are stored per object
        with open(outpath, "w") as outfile:
            for i, (category, name) in enumerate(self.list):
                outfile.write(f"{i} {self.path}/images_processed/{category}/{name}.png "
                              f"{self.path}/masks_processed/{category}/{name}.png "
                              f"{self.path}/pointclouds/{category}/{name}.npy\n")

    def __getitem__(self, idx):
        opt = self.opt
        category, name = self.list[idx]
        sample = {"idx": np.int64(idx), "category_label": np.int64(self.cat2label[category])}
        Rt = np.load(os.path.join(self.path, "camera_data", "extr", category, name + ".npy")).astype(np.float32)
        sample["pose_gt"] = common.pose_from_Rt(Rt)
        sample["intr"] = common.fixed_intrinsics(opt.H, opt.W)
        rgb = common.load_rgb(os.path.join(self.path, "images_processed", category, name + ".png"),
                              out_hw=(opt.H, opt.W))
        depth = common.load_npy_f32(os.path.join(self.path, self.depth_dirname, category, name + ".npy"))
        depth = depth.astype(np.float32)[..., None]
        common.check_depth_size(depth, opt)
        mask = (depth != 0).astype(np.float32)
        if opt.data.get("bgcolor") is not None:
            rgb = rgb * mask + opt.data.bgcolor * (1 - mask)
        sample["rgb_input_map"] = rgb
        sample["mask_input_map"] = mask
        sample["depth_input_map"] = depth
        erode = self.has_erode and (opt.data.get("ocrtoc") or {}).get("erode_mask")
        if erode:
            sample["mask_eroded"] = common.erode_mask_np(mask[..., 0], erode)[..., None]
        if self.load_3D:
            pc_name = "_".join(name.split("_")[:-1])
            pc = np.load(os.path.join(self.path, "pointclouds", category, pc_name + ".npy")).astype(np.float32)
            sample["dpc"] = {"points": pc}
        return sample

    def __len__(self):
        return len(self.list)


Dataset = OcrtocDataset
