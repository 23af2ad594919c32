"""The synthetic training set on disk (counterpart of ``zeroshape_tpu/data/synthetic.py``):
Objaverse-LVIS + ShapeNet55 renders, or the analytic tree of
:func:`data.analytic.generate_dataset`, in the reference's layout.

Per subset: ``lists/{cat}_{split}.list``, ``images_processed/``, ``depth/``,
``camera_data/{intr,extr}/``, ``pointclouds/`` and ``gt_sdf/``. The
``data.synthetic.percentage`` prefix, then the per-category cap of 10
validation images; the GT SDF offset of -0.003; the SDF subsample drawn by
``default_rng((seed, idx, epoch))``.
"""

from __future__ import annotations

import os

import numpy as np

from zeroshape_tpu_torch.data import base, common
from zeroshape_tpu_torch.data.common import check_depth_size


class SyntheticDataset(base.Dataset):
    def __init__(self, opt, split="train", load_3D=True):
        if split == "test":
            split = "val"
        super().__init__(opt, split)
        self.path = os.path.join(opt.data.get("root", "data"), "train_data")
        self.load_3D = load_3D
        self.subsets = opt.data.synthetic.subset.split(",")
        self.category_dict, self.category_list = {}, []
        for subset in self.subsets:
            lists_dir = os.path.join(self.path, subset, "lists")
            cats = [name[:-11] for name in sorted(os.listdir(lists_dir)) if name.endswith("_train.list")]
            self.category_dict[subset] = cats
            self.category_list += cats
        if split == "val":
            self.max_imgs, self.data_percentage = 10, 1
        else:
            self.max_imgs, self.data_percentage = np.inf, opt.data.synthetic.get("percentage", 1)
        self.cat2label = {cat: i for i, cat in enumerate(self.category_list)}
        self.label2cat = list(self.category_list)
        self.list = self.get_list(opt, split)
        self.seed = opt.get("seed", 0) or 0

    def get_list(self, opt, split):
        """``(subset, category, object, sample)`` of each listed image: the
        percentage prefix, then the per-category cap (``synthetic.py:50-77``)."""
        entries = []
        for subset in self.subsets:
            for cat in self.category_dict[subset]:
                list_fname = os.path.join(self.path, subset, "lists", f"{cat}_{split}.list")
                if not os.path.isfile(list_fname):
                    continue
                with open(list_fname) as fh:
                    stems = [ln.rsplit(".", 1)[0] for ln in fh.read().splitlines() if ln]
                stems = stems[: round(self.data_percentage * len(stems))]
                if len(stems) > self.max_imgs:
                    stems = stems[: int(self.max_imgs)]
                for stem in stems:
                    # "{cat}_{object}_{sample}": the object may hold underscores
                    if not stem.startswith(cat + "_"):
                        raise ValueError(f"{list_fname}: {stem!r} is not named {cat}_<object>_<sample>")
                    object_name, sample_id = stem[len(cat) + 1:].rsplit("_", 1)
                    entries.append((subset, cat, object_name, sample_id))
        return entries

    def id_filename_mapping(self, opt, outpath):
        """``data_list.txt``: each index and its image, mask and point-cloud paths."""
        with open(outpath, "w") as outfile:
            for i, (subset, category, object_name, sample_id) in enumerate(self.list):
                stem = f"{category}/{category}_{object_name}_{sample_id}"
                image = os.path.join(self.path, subset, "images_processed", stem + ".png")
                mask = os.path.join(self.path, subset, "masks", stem + ".png")
                pc = os.path.join(self.path, subset, "pointclouds", f"{category}/{category}_{object_name}.npy")
                outfile.write(f"{i} {image} {mask} {pc}\n")

    def _file(self, subset, folder, category, name, ext):
        return os.path.join(self.path, subset, folder, f"{category}/{category}_{name}{ext}")

    def __getitem__(self, idx):
        opt = self.opt
        subset, cat, obj, sid = self.list[idx]
        view = f"{obj}_{sid}"
        sample = {"idx": np.int64(idx), "category_label": np.int64(self.cat2label[cat])}
        K = np.load(self._file(subset, "camera_data/intr", cat, view, ".npy")).astype(np.float32)
        Rt = np.load(self._file(subset, "camera_data/extr", cat, view, ".npy")).astype(np.float32)
        sample["pose_gt"] = common.pose_from_Rt(Rt)
        sample["intr"] = K
        rgb = common.load_rgb(self._file(subset, "images_processed", cat, view, ".png"), out_hw=(opt.H, opt.W))
        depth = common.load_npy_f32(self._file(subset, "depth", cat, view, ".npy")).astype(np.float32)[..., None]
        check_depth_size(depth, opt)
        sample["rgb_input_map"] = rgb
        sample["mask_input_map"] = (depth != 0).astype(np.float32)
        sample["depth_input_map"] = depth
        if not self.load_3D:
            return sample
        pc = np.load(self._file(subset, "pointclouds", cat, obj, ".npy")).astype(np.float32)
        sample["dpc"] = {"points": pc}
        gt = np.load(self._file(subset, "gt_sdf", cat, obj, ".npy"), allow_pickle=True).item()
        pts = gt["sample_pt"].astype(np.float32)
        sdf = gt["sample_sdf"].astype(np.float32) - 0.003
        n = opt.training.get("n_sdf_points")
        if n:
            # keyed on (seed, sample, epoch): thread scheduling never decides
            # the subset, and a resumed run continues the per-epoch draws
            sel = np.random.default_rng((self.seed, idx, self._epoch)).permutation(pts.shape[0])[:n]
            pts, sdf = pts[sel], sdf[sel]
        sample["gt_sample_points"] = pts
        sample["gt_sample_sdf"] = sdf
        return sample

    def __len__(self):
        return len(self.list)


Dataset = SyntheticDataset
