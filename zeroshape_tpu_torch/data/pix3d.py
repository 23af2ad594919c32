"""The Pix3D evaluation set (counterpart of ``zeroshape_tpu/data/pix3d.py``):
9 categories, JSON metadata, images and masks under ``*_processed``
resized to ``(H, W)``, the mask ``> 0.5``, the pose ``[R | (0, 0, 1.78)]``
with f = 1.3875, the GT cloud at ``pointclouds/`` + ``cad_path[6:]`` with
``.obj`` -> ``.npy``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from zeroshape_tpu_torch.data import base, common

CAT_ID_ALL = dict(bed="bed", bookcase="bookcase", chair="chair", desk="desk", misc="misc", sofa="sofa",
                  table="table", tool="tool", wardrobe="wardrobe")


class Pix3DDataset(base.Dataset):
    """``load_3D=False`` leaves out the ``dpc`` key (depth-only use)."""

    def __init__(self, opt, split="test", load_3D=True):
        super().__init__(opt, split)
        self.path = os.path.join(opt.data.get("root", "data"), "Pix3D")
        self.load_3D = load_3D
        self.max_imgs = opt.data.get("max_img_cat") if opt.data.get("max_img_cat") is not None else np.inf
        cat_sel = opt.data.pix3d.get("cat")
        self.cat_id = (list(CAT_ID_ALL.values()) if cat_sel is None
                       else [v for k, v in CAT_ID_ALL.items() if k in cat_sel.split(",")])
        self.cat2label = {c: i for i, c in enumerate(self.cat_id)}
        self.label2cat = [next(k for k, v in CAT_ID_ALL.items() if v == c) for c in self.cat_id]
        self.list = self.get_list(opt, split)

    def get_list(self, opt, split):
        cads = []
        for c in self.cat_id:
            with open(os.path.join(self.path, "lists", f"{c}_{split}.txt")) as f:
                for i, m in enumerate(f.read().splitlines()):
                    if i >= self.max_imgs:
                        break
                    cads.append((c, m))
        return cads

    def id_filename_mapping(self, opt, outpath):
        with open(outpath, "w") as outfile:
            for i in range(len(self.list)):
                meta = self.get_metadata(opt, i)
                pc_fname = (f"{self.path}/pointclouds/" + meta["cad_path"][6:]).replace(".obj", ".npy")
                outfile.write(f"{i} {self.path}/{meta['img_path']} {self.path}/{meta['mask_path']} {pc_fname}\n")

    def get_metadata(self, opt, idx):
        c, name = self.list[idx]
        with open(os.path.join(self.path, "annotation", c, name + ".json"), encoding="utf-8") as f:
            meta = json.load(f)
        return {"img_path": meta["img"].replace("img", "img_processed"),
                "mask_path": meta["mask"].replace("mask", "mask_processed"),
                "cad_path": meta["model"], "R": np.asarray(meta["rot_mat"], np.float32)}

    def __getitem__(self, idx):
        opt = self.opt
        c, _ = self.list[idx]
        meta = self.get_metadata(opt, idx)
        sample = {"idx": np.int64(idx), "category_label": np.int64(self.cat2label[c])}
        rgb = common.to_float(common.load_image(os.path.join(self.path, meta["img_path"]), (opt.H, opt.W), "RGB"))
        mask = common.to_float(common.load_image(os.path.join(self.path, meta["mask_path"]), (opt.H, opt.W), "L"))
        m = (mask > 0.5).astype(np.float32)
        if opt.data.get("bgcolor") is not None:
            rgb = rgb * m + opt.data.bgcolor * (1 - m)
        sample["rgb_input_map"] = rgb
        sample["mask_input_map"] = m
        pose = np.concatenate([meta["R"], np.array([[0.0], [0.0], [1.78]], np.float32)], axis=1)
        sample["pose_gt"] = pose.astype(np.float32)
        sample["intr"] = common.fixed_intrinsics(opt.H, opt.W)
        if self.load_3D:
            pc_fname = os.path.join(self.path, "pointclouds", meta["cad_path"][6:]).replace(".obj", ".npy")
            sample["dpc"] = {"points": np.load(pc_fname).astype(np.float32)}
        return sample

    def __len__(self):
        return len(self.list)


Dataset = Pix3DDataset
